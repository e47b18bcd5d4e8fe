"""The reference's reliability-tier and serving-path config keys in the
port's ``ServerConfig`` (``easydarwin_tpu_torch.server.config``), held
against the reference's (``easydarwin_tpu.server.config``) on the CPU:

* the fifteen keys' defaults equal the reference's;
* a guard: the reference's keys, less the port's and less the five it
  serves through ``stream`` (``StreamSettings``), are exactly the three
  left out by design (``tpu_fanout``, ``tpu_min_outputs``,
  ``egress_backend``);
* a TOML of every key at a non-default value loads to the same values in
  both packages with the same unmapped keys, and the reference's whole
  TOML leaves exactly those three unmapped in the port;
* ``fec_config`` raises the reference's ``ValueError`` on a bad window,
  kind or pair of payload types, and a server with ``fec_enabled`` and a
  bad window fails at start in both packages;
* REST ``setbaseconfig`` answers 200 on each of the fifteen keys and
  ``getbaseconfig`` reads each back.
"""

import dataclasses
import json

import pytest

from easydarwin_tpu.server import config as ref_config
from easydarwin_tpu.server.app import StreamingServer as RefServer
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.server import config
from easydarwin_tpu_torch.utils.keys_loopback import KEY_VALUES
from easydarwin_tpu_torch.utils.surface_loopback import envelope, rest

#: the fifteen keys the port took from the reference
KEYS = ("reliable_udp", "fec_enabled", "fec_window", "fec_max_overhead",
        "fec_kind", "fec_payload_type", "rtx_payload_type",
        "rtx_budget_per_sec", "rtx_burst", "fec_device",
        "megabatch_enabled", "megabatch_min_streams", "tcp_engine_enabled",
        "storage_device", "timeout_sweep_sec")
#: the reference's keys the port leaves out by design
LEFT_OUT = {"tpu_fanout", "tpu_min_outputs", "egress_backend"}


def _ref_keys() -> set[str]:
    return {f.name for f in dataclasses.fields(ref_config.ServerConfig)
            if not f.name.startswith("_")}


def test_the_fifteen_keys_default_as_the_reference():
    assert set(KEY_VALUES) == set(KEYS)
    port, ref = ServerConfig(), ref_config.ServerConfig()
    for k in KEYS:
        assert getattr(port, k) == getattr(ref, k), k
        assert type(getattr(port, k)) is type(getattr(ref, k)), k
        assert KEY_VALUES[k] != getattr(ref, k), k


def test_no_reference_key_goes_missing_again():
    port = {f.name for f in dataclasses.fields(ServerConfig)}
    assert _ref_keys() - port - set(config.STREAM_KEYS) == LEFT_OUT
    assert set(KEYS) <= ServerConfig.keys()


def test_a_toml_of_every_key_loads_as_the_reference(tmp_path):
    p = tmp_path / "keys.toml"
    lines = [f"{k} = {json.dumps(v)}" for k, v in KEY_VALUES.items()]
    p.write_text("\n".join(lines) + "\n")
    cfg, unmapped = config.load_toml(str(p))
    ref = ref_config.ServerConfig.from_toml(str(p))
    ref_unmapped = [k for k in KEY_VALUES if k not in _ref_keys()]
    for k, v in KEY_VALUES.items():
        assert getattr(cfg, k) == getattr(ref, k) == v, k
    assert unmapped == ref_unmapped == []
    d = cfg.to_dict()
    assert all(d[k] == v for k, v in KEY_VALUES.items())
    assert ServerConfig.from_dict(d).to_dict() == d
    # the reference's whole TOML: exactly the three left out stay unmapped
    whole = tmp_path / "ref.toml"
    whole.write_text(ref_config.ServerConfig(**KEY_VALUES).to_toml())
    cfg, unmapped = config.load_toml(str(whole))
    assert set(unmapped) == LEFT_OUT and len(unmapped) == 3
    assert all(getattr(cfg, k) == v for k, v in KEY_VALUES.items())
    assert config.load_config(str(whole))[1] == unmapped


def test_update_serves_the_keys_and_casts_them():
    cfg = ServerConfig()
    seen = []
    cfg.on_change(lambda c: seen.append(c.fec_window))
    cfg.update(fec_window="8", megabatch_min_streams=3.0,
               fec_max_overhead=1, fec_kind="xor", timeout_sweep_sec=2)
    assert (cfg.fec_window, cfg.megabatch_min_streams, cfg.fec_max_overhead,
            cfg.fec_kind, cfg.timeout_sweep_sec) == (8, 3, 1.0, "xor", 2)
    assert type(cfg.fec_max_overhead) is float and seen == [8]


@pytest.mark.parametrize("kw", [dict(fec_window=1), dict(fec_window=65),
                                dict(fec_kind="xx"),
                                dict(fec_payload_type=120,
                                     rtx_payload_type=120),
                                dict(fec_payload_type=128)])
def test_fec_config_raises_the_reference_error(kw):
    with pytest.raises(ValueError) as ref_err:
        ref_config.ServerConfig(**kw).fec_config()
    with pytest.raises(ValueError) as port_err:
        ServerConfig(**kw).fec_config("cpu")
    assert str(port_err.value) == str(ref_err.value)


def test_fec_config_carries_every_key_and_the_device():
    cfg = ServerConfig(**{k: KEY_VALUES[k] for k in KEYS
                          if k.startswith(("fec_", "rtx_"))})
    ref = ref_config.ServerConfig(**{k: KEY_VALUES[k] for k in KEYS
                                     if k.startswith(("fec_", "rtx_"))})
    port_fc, ref_fc = cfg.fec_config("cpu"), ref.fec_config()
    for f in dataclasses.fields(ref_fc):
        assert getattr(port_fc, f.name) == getattr(ref_fc, f.name), f.name
    assert port_fc.use_device is False and port_fc.device is None
    on = ServerConfig().fec_config("cpu")
    assert on.use_device is True and on.device == "cpu"


async def test_a_bad_window_fails_the_start_in_both(tmp_path):
    kw = dict(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
              fec_window=1, log_folder=str(tmp_path / "logs"),
              movie_folder=str(tmp_path / "movies"))
    app = StreamingServer(ServerConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="fec_window must be 2..48"):
        await app.start()
    assert app.rtsp.port is None and app._pump_task is None
    ref = RefServer(ref_config.ServerConfig(**kw))
    with pytest.raises(ValueError, match="fec_window must be 2..48"):
        await ref.start()
    # off, the bad window is never read
    app = StreamingServer(ServerConfig(**kw, fec_enabled=False),
                          device="cpu")
    await app.start()
    await app.stop()


async def test_setbaseconfig_serves_each_key(tmp_path):
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        log_folder=str(tmp_path / "logs"),
        movie_folder=str(tmp_path / "movies")), device="cpu")
    await app.start()
    try:
        for k, v in KEY_VALUES.items():
            status, doc = await rest(
                app.rest.port, "setbaseconfig",
                body=json.dumps({"Config": {k: v}}).encode())
            assert status == 200, (k, doc)
            envelope("setbaseconfig", status, doc)
        cfg = envelope("getbaseconfig", *await rest(
            app.rest.port, "getbaseconfig"))["Config"]
        assert {k: cfg[k] for k in KEYS} == KEY_VALUES
        assert all(getattr(app.config, k) == v for k, v in KEY_VALUES.items())
    finally:
        await app.stop()
