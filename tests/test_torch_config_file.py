"""The port's config file: TOML, the reference's ``easydarwin.xml``, the
unmapped list, ``update`` / ``on_change`` and the CLI's ``-c`` and ``-x``.

* the reference's XML (the reference's own test document, and edge
  cases: LIST-PREF extras, malformed values, strict DSS bools) loads to
  the reference loader's value for every key both sides map; the port's
  unmapped list holds every pref the reference's leaves unmapped that
  the port does not serve, and every pref the reference maps to a key
  the port does not serve;
* a TOML written by the reference's ``to_toml`` loads to the reference's
  values for every shared key (the SLO watchdog's ``slo_*``, the status
  keys, the cluster's ``cluster_*`` and Redis keys and EasyCMS's
  ``cms_host`` and ``cms_port`` among them), and each reference key the
  port lacks (the JAX fan-out switches, …) is in the unmapped list, none
  dropped in silence;
* ``to_toml`` round trips; ``update`` casts, routes the relay keys into
  ``stream``, runs the ``on_change`` listeners and raises ``KeyError``
  on an unknown key before changing anything;
* the CLI: flags apply over the file, content decides XML or TOML, and
  ``python -m easydarwin_tpu_torch -c FILE -x`` boots, prints the
  unmapped keys and exits 0.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from easydarwin_tpu.server import config as ref_config
from easydarwin_tpu_torch import __main__ as cli
from easydarwin_tpu_torch.server import config

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_config_xml import REFERENCE_XML  # noqa: E402

EDGE_XML = """<?xml version ="1.0"?>
<CONFIGURATION><SERVER>
  <LIST-PREF NAME="rtsp_port"><VALUE>554</VALUE><VALUE>10554</VALUE></LIST-PREF>
  <PREF NAME="maximum_connections">abc</PREF>
  <PREF NAME="error_logfile_verbosity">-1</PREF>
  <PREF NAME="http_service_port">80</PREF>
  <PREF NAME="service_lan_port">10008</PREF>
  <PREF NAME="enable_cloud_platform">True</PREF>
  <PREF NAME="bind_ip_addr"></PREF>
  <PREF NAME="max_connections_per_ip">5</PREF>
</SERVER>
<MODULE NAME="QTSSSpamDefenseModule">
  <PREF NAME="num_conns_per_ip_addr">4</PREF>
</MODULE>
<MODULE NAME="QTSSAccessModule">
  <PREF NAME="modAccess_enabled">true</PREF>
  <PREF NAME="modAccess_usersfilepath">/etc/qtusers</PREF>
</MODULE>
<MODULE NAME="QTSSAccessLogModule">
  <PREF NAME="request_logging">maybe</PREF>
</MODULE></CONFIGURATION>"""

#: DSS prefs the port maps that the reference's loader leaves unmapped
PORT_ONLY = {"QTSSSpamDefenseModule/num_conns_per_ip_addr",
             "QTSSAccessModule/modAccess_enabled",
             "QTSSAccessModule/modAccess_usersfilepath"}


def _name(entry: str) -> str:
    return entry.split(" (")[0]


@pytest.mark.parametrize("text", [REFERENCE_XML, EDGE_XML],
                         ids=["reference", "edge"])
def test_reference_xml_loads_as_the_reference(tmp_path, text):
    p = tmp_path / "easydarwin.xml"
    p.write_text(text)
    ref_cfg, ref_unmapped = ref_config.load_reference_xml(str(p))
    cfg, unmapped = config.load_reference_xml(str(p))
    ref_d, d = ref_cfg.to_dict(), cfg.to_dict()
    set_by_file = {k for k in ref_d
                   if ref_d[k] != ref_config.ServerConfig().to_dict()[k]}
    shared = set_by_file & set(d)
    assert shared, "the document set no shared key"
    for k in shared:
        assert d[k] == ref_d[k], k
    # every reference-unmapped pref is unmapped here too, but the ones
    # the port serves; a malformed value of a key both serve is reported
    # the same way
    assert {_name(e) for e in ref_unmapped} - PORT_ONLY \
        <= {_name(e) for e in unmapped}
    served = {n for k in d for n in _xml_names_of(k)}
    assert ({e for e in ref_unmapped if _name(e) in served}
            == {e for e in unmapped if _name(e) in served})
    # the reference's mapped keys this port does not serve are listed
    for k in set_by_file - set(d):
        assert any(k in e or e in _xml_names_of(k) for e in unmapped), k


def _xml_names_of(key: str) -> set[str]:
    names = {n for n, (f, _c) in ref_config._XML_SERVER_MAP.items()
             if f == key}
    names |= {f"{m}/{n}" for (m, n), (f, _c)
              in ref_config._XML_MODULE_MAP.items() if f == key}
    return names


def test_port_only_prefs_and_strict_values(tmp_path):
    p = tmp_path / "e.xml"
    p.write_text(EDGE_XML)
    cfg, unmapped = config.load_reference_xml(str(p))
    assert cfg.rtsp_port == 554 and cfg.service_port == 10008
    assert cfg.bind_ip == "0.0.0.0" and cfg.max_connections == 20000
    assert cfg.max_connections_per_ip == 4     # the DSS module pref
    assert cfg.rtsp_auth_enabled and cfg.users_file == "/etc/qtusers"
    assert cfg.access_log_enabled              # 'maybe' is not a DSS bool
    joined = "\n".join(unmapped)
    for want in ("extra values dropped", "maximum_connections (invalid "
                 "value 'abc')", "error_logfile_verbosity (invalid value",
                 "http_service_port", "enable_cloud_platform",
                 # a SERVER pref named after a port key is no DSS pref
                 "max_connections_per_ip",
                 "QTSSAccessLogModule/request_logging (invalid value "
                 "'maybe')"):
        assert want in joined, want


def test_reference_toml_loads_with_every_missing_key_listed(tmp_path):
    ref = ref_config.ServerConfig(
        rtsp_port=1554, bucket_delay_ms=61, overbuffer_sec=3.5,
        max_packet_age_sec=9.0, ring_capacity=2048, auth_enabled=True,
        rest_password="pw", max_connections_per_ip=7, wan_ip="10.0.0.9",
        slo_enabled=False, cluster_enabled=True, access_log_enabled=False,
        error_log_verbosity="debug", movie_folder=str(tmp_path))
    p = tmp_path / "ref.toml"
    p.write_text(ref.to_toml())
    cfg, unmapped = config.load_toml(str(p))
    ref_d, d = ref.to_dict(), cfg.to_dict()
    for k in set(ref_d) & set(d):
        assert d[k] == ref_d[k], k
    assert set(unmapped) == set(ref_d) - set(d)
    for k in ("tpu_fanout",):
        assert k in unmapped
    for k in ("cluster_enabled", "redis_host", "cloud_enabled",
              "cms_host", "cms_port",
              "cluster_lease_ttl_sec", "cluster_pull_backoff_ms",
              "cluster_admission_high_water", "slo_enabled", "slo_latency_objective_ms", "stats_interval_sec",
              "status_file_path", "status_file_interval_sec",
              "module_folder", "resilience_fault_plan", "resilience_enabled",
              "resilience_recover_sec", "resilience_max_retries",
              "resilience_backoff_ms", "resilience_checkpoint_enabled",
              "resilience_checkpoint_interval_sec",
              "resilience_checkpoint_max_age_sec"):
        assert k not in unmapped and d[k] == ref_d[k], k
    assert cfg.stream.overbuffer_ms == 3500 and cfg.stream.max_age_ms == 9000
    assert config.ServerConfig.from_toml(str(p)).to_dict() == d


def test_to_toml_round_trips(tmp_path):
    cfg = config.ServerConfig(rtsp_port=0, users_file="/etc/qtusers",
                              dvr_retention_sec=2.5, dvr_enabled=True)
    cfg.update(bucket_size=8)
    p = tmp_path / "c.toml"
    p.write_text(cfg.to_toml())
    back, unmapped = config.load_toml(str(p))
    assert unmapped == [] and back.to_dict() == cfg.to_dict()
    assert "hls_device" not in cfg.to_toml()       # None is left out


def test_update_casts_routes_and_notifies():
    cfg = config.ServerConfig()
    seen = []
    cfg.on_change(lambda c: seen.append(c.to_dict()["bucket_delay_ms"]))
    cfg.update(bucket_delay_ms="50", rtsp_timeout_sec=90.0,
               overbuffer_sec=2)
    assert cfg.stream.bucket_delay_ms == 50 and cfg.rtsp_timeout_sec == 90
    assert cfg.stream.overbuffer_ms == 2000 and seen == [50]
    with pytest.raises(KeyError):
        cfg.update(rtsp_timeout_sec=5, tpu_fanout=True)
    assert cfg.rtsp_timeout_sec == 90 and seen == [50]
    with pytest.raises(KeyError):
        cfg.update(_listeners=[])
    ref = ref_config.ServerConfig()
    ref.update(bucket_delay_ms="50", rtsp_timeout_sec=90.0)
    assert ref.bucket_delay_ms == cfg.to_dict()["bucket_delay_ms"]


def test_cli_flags_apply_over_the_file_and_content_decides(tmp_path):
    x = tmp_path / "easydarwin.conf"            # XML under any name
    x.write_text(REFERENCE_XML)
    cfg, unmapped = cli.config_from_args(["-c", str(x), "-p", "0",
                                          "--dvr-enabled", "1"])
    assert cfg.rtsp_port == 0 and cfg.service_port == 10008
    assert cfg.movie_folder == "/srv/movies" and cfg.dvr_enabled is True
    assert "run_num_threads" in unmapped
    t = tmp_path / "c.xml"                       # TOML under an XML name
    t.write_text('rtsp_port = 7\nmovie_folder = "/m"\ntpu_fanout = true\n')
    cfg, unmapped = cli.config_from_args(["-c", str(t),
                                          "--movie-folder", "/n"])
    assert (cfg.rtsp_port, cfg.movie_folder) == (7, "/n")
    assert unmapped == ["tpu_fanout"]
    cfg, unmapped = cli.config_from_args(["--service-port", "9"])
    assert cfg.service_port == 9 and cfg.rtsp_port == 10554
    assert unmapped == []


@pytest.mark.parametrize("kind", ["xml", "toml"])
def test_cli_boots_from_a_file_and_exits(tmp_path, kind):
    p = tmp_path / f"cfg.{kind}"
    if kind == "xml":
        p.write_text(REFERENCE_XML.replace("/srv/movies", str(tmp_path)))
    else:
        p.write_text(f'movie_folder = "{tmp_path}"\nslo_enabled = true\n'
                     f'tpu_fanout = true\nlog_folder = "{tmp_path}"\n')
    out = subprocess.run(
        [sys.executable, "-m", "easydarwin_tpu_torch", "-c", str(p), "-x",
         "--device", "cpu", "-p", "0", "--service-port", "0",
         "--bind-ip", "127.0.0.1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("unmapped: ")
    assert ("run_num_threads" if kind == "xml" else "tpu_fanout") \
        in lines[0]
    assert "listening: rtsp://127.0.0.1:" in lines[1]
