"""The port's CLI against the reference's on two points of its surface.

* SIGHUP re-reads the prefs and the server keeps serving: the handler,
  in place before the ``listening:`` line, calls ``update()`` on the
  running server's config, which runs every registered module's
  ``reread_prefs`` (the reference maps SIGHUP to ``cfg.update()``);
  SIGTERM then exits 0.
* ``-S``/``--stats-interval N``, ``--status-file PATH`` and
  ``--module-folder DIR`` set ``stats_interval_sec``,
  ``status_file_path`` and ``module_folder`` as the reference's
  ``config_from_args`` does, and a flag wins over the same key in a
  ``-c`` file.
"""

import argparse
import asyncio
import signal
import sys
from pathlib import Path

import pytest

from easydarwin_tpu import __main__ as ref_cli
from easydarwin_tpu_torch import __main__ as cli
from easydarwin_tpu_torch.utils.loopback import CliServer, MiniClient

PLUGIN = '''
from easydarwin_tpu_torch.server.modules import Module


class CountRereads(Module):
    name = "count_rereads"

    def reread_prefs(self, config):
        with open({marker!r}, "a") as f:
            f.write("x")
'''


async def _options(port: int) -> int:
    cli_ = MiniClient()
    await cli_.connect(port)
    try:
        resp = await cli_.request("OPTIONS", f"rtsp://127.0.0.1:{port}/")
        return resp.status
    finally:
        await cli_.close()


async def test_sighup_rereads_prefs_and_keeps_serving(tmp_path):
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    marker = tmp_path / "rereads"
    (plugins / "count_rereads.py").write_text(
        PLUGIN.format(marker=str(marker)))
    srv = CliServer("cpu", "--module-folder", str(plugins),
                    "--log-folder", str(tmp_path / "logs"))
    async with srv:
        assert await _options(srv.rtsp_port) == 200
        assert not marker.exists()
        srv.proc.send_signal(signal.SIGHUP)
        for _ in range(100):
            if marker.exists():
                break
            await asyncio.sleep(0.05)
        assert srv.proc.returncode is None          # still running
        assert await _options(srv.rtsp_port) == 200
        assert marker.read_text() == "x"            # reread_prefs ran once
        stats = await srv.stop()
        assert srv.proc.returncode == 0
        assert stats["pump_errors"] == 0


async def test_sighup_without_modules_keeps_serving(tmp_path):
    srv = CliServer("cpu", "--log-folder", str(tmp_path / "logs"))
    async with srv:
        for _ in range(2):
            srv.proc.send_signal(signal.SIGHUP)
            await asyncio.sleep(0.3)
            assert srv.proc.returncode is None
            assert await _options(srv.rtsp_port) == 200
        await srv.stop()
        assert srv.proc.returncode == 0


def _ref_cfg(argv):
    return ref_cli.config_from_args(ref_cli.build_parser().parse_args(argv))


@pytest.mark.parametrize("argv, key, want", [
    (["-S", "7"], "stats_interval_sec", 7),
    (["--stats-interval", "3"], "stats_interval_sec", 3),
    (["--status-file", "/x/status.json"], "status_file_path",
     "/x/status.json"),
    (["--module-folder", "/x/plugins"], "module_folder", "/x/plugins"),
])
def test_status_flags_set_the_keys_as_the_reference(argv, key, want):
    cfg, unmapped = cli.config_from_args(argv)
    assert unmapped == []
    assert getattr(cfg, key) == want
    assert getattr(_ref_cfg(argv), key) == want


def test_status_flags_win_over_the_config_file(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text('stats_interval_sec = 30\nstatus_file_path = "/a.json"\n'
                 'module_folder = "/m"\n')
    cfg, _ = cli.config_from_args(["-c", str(p)])
    assert (cfg.stats_interval_sec, cfg.status_file_path,
            cfg.module_folder) == (30, "/a.json", "/m")
    argv = ["-c", str(p), "-S", "5", "--status-file", "/b.json",
            "--module-folder", "/n"]
    cfg, _ = cli.config_from_args(argv)
    assert (cfg.stats_interval_sec, cfg.status_file_path,
            cfg.module_folder) == (5, "/b.json", "/n")
    ref = _ref_cfg(argv)
    assert (ref.stats_interval_sec, ref.status_file_path,
            ref.module_folder) == (5, "/b.json", "/n")


def test_tpu_fanout_stays_out_of_the_port():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--tpu-fanout"])
    assert isinstance(ref_cli.build_parser().parse_args(["--tpu-fanout"]),
                      argparse.Namespace)


def test_cli_help_names_the_flags():
    text = cli.build_parser().format_help()
    for flag in ("--stats-interval", "--status-file", "--module-folder"):
        assert flag in text
    assert Path(sys.executable).exists()
