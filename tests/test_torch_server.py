"""The port's server end to end on the CPU, and what the port imports.

* a loopback push → play through ``python -m easydarwin_tpu_torch
  --device cpu``: 1 source × 2 interleaved TCP players, every relayed
  packet held to what was pushed (``utils.loopback``);
* importing the port, its server, its CLI, the transcode modules and
  the REST API leaves ``jax`` and ``easydarwin_tpu`` out of
  ``sys.modules``;
* the CLI's device defaults to the card, and without one it raises.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from easydarwin_tpu_torch import __main__ as cli
from easydarwin_tpu_torch.utils import loopback

ROOT = Path(__file__).resolve().parents[1]


async def test_loopback_push_play_through_the_cli_on_cpu():
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(2026), n_push=1, n_play=2,
        deadline_s=10)
    assert res["players"] == 2 and res["packets_per_player"] == 80
    stats = res["server_stats"]
    assert stats["packets_in"] == 80
    assert stats["packets_out"] == 2 * 80      # fast start replays GOP 1
    assert stats["megabatch"]["installs"] > 0
    # CPU tensors take the plain versions: no kernel was launched
    assert stats["kernel_launches"] == {"ed_parse_packets": 0,
                                        "ed_relay_window": 0,
                                        "ed_decode_blocks": 0}


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import easydarwin_tpu_torch, easydarwin_tpu_torch.__main__\n"
            "import easydarwin_tpu_torch.convert, easydarwin_tpu_torch.server\n"
            "import easydarwin_tpu_torch.ops.parse_kernel\n"
            "import easydarwin_tpu_torch.ops.transform_kernel\n"
            "import easydarwin_tpu_torch.models.transcode_pipeline\n"
            "import easydarwin_tpu_torch.models.mjpeg_ladder\n"
            "import easydarwin_tpu_torch.server.rest\n"
            "import easydarwin_tpu_torch.utils.loopback\n"
            "import easydarwin_tpu_torch.utils.mjpeg_loopback\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'easydarwin_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_device_defaults_to_the_card():
    args = cli.build_parser().parse_args([])
    assert args.device == "cuda"
    assert cli.build_parser().parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--device", "mps"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["-p", "0", "--bind-ip", "127.0.0.1"])
