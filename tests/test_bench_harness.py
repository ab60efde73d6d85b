"""bench.py: the JSON line it composes, and its refusal to measure
anything but a GPU. The measurements themselves need the card."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402

DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_compose_full():
    out = bench.compose({
        "fwd": {"rays_per_s": 1e8, "seconds": 1.0, "frames": 32,
                "compile_s": 20.0},
        "fwd_bwd": {"rays_per_s": 5e7, "s_per_step": 0.2, "compile_s": 60.0},
        "parity": {"room_128_frac_off": 0.0},
        "textured": {"rays_per_s": 4e7, "seconds": 2.0, "frames": 16,
                     "compile_s": 30.0},
    }, DEVICE)
    assert out["value"] == 1e8
    assert out["device"] == DEVICE
    assert "vs_baseline" not in out
    assert out["detail"]["fwd_bwd_rays_per_s"] == 5e7
    assert out["detail"]["textured_rays_per_s"] == 4e7
    assert out["detail"]["on_device_parity"] == {"room_128_frac_off": 0.0}
    json.dumps(out)  # must be JSON-serializable


def test_main_refuses_without_gpu(capsys):
    assert bench.main() != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no GPU" in captured.err
