"""Smoke tests for the viewer renderers and utils subsystems."""

import json

import numpy as np

from tyrant_tpu.camera import Camera
from tyrant_tpu.config import small_config
from tyrant_tpu.render import Renderer
from tyrant_tpu.scene.scene import Scene
from tyrant_tpu.utils.metrics import Metrics, render_stats
from tyrant_tpu.viewer import TerminalViewer, _to_png_bytes


def test_terminal_viewer_ansi():
    img = np.zeros((32, 64, 3), np.uint8)
    img[:16] = [255, 0, 0]
    img[16:] = [0, 0, 255]
    r = Renderer(Scene.load(None), small_config(16, 16, 1 << 8), donate=False)
    tv = TerminalViewer(r, Camera(), cols=32)
    s = tv._ansi(img)
    assert "\x1b[38;2;255;0;0m" in s
    assert "\x1b[48;2;0;0;255m" in s
    assert s.count("\n") >= 3


def test_png_bytes():
    img = np.random.default_rng(0).integers(0, 255, (8, 8, 3)).astype(np.uint8)
    png = _to_png_bytes(img)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_metrics_emit(capsys):
    import io
    sink = io.StringIO()
    m = Metrics(sink=sink)
    m.count("frames")
    m.count("frames")
    with m.time("step"):
        pass
    rec = m.emit(tag="x")
    assert rec["frames"] == 2
    assert "step_ms_avg" in rec
    parsed = json.loads(sink.getvalue())
    assert parsed["tag"] == "x"


def test_render_stats():
    cfg = small_config(8, 8, 1 << 8)
    r = Renderer(Scene.load(None), cfg, donate=False)
    r.step(Camera(), 2)
    s = render_stats(r.state, cfg)
    assert s["frame"] == 3
    assert 0.0 <= s["carry_fraction"] <= 1.0


def test_missing_scene_degrades(tmp_path, capsys):
    sc = Scene.load(str(tmp_path / "nope.ply"))
    assert sc.bvh is None
    assert sc.stats["nodes"] == 0


def test_interactive_config_preset():
    """The fly-through preset: a 128k wavefront at 1080p with fused step
    chains; keyword arguments override or pass through, and the removed
    kernel-selection fields are not accepted (kernel choice follows the
    platform, ops.traverse.traversal_for)."""
    import pytest

    from tyrant_tpu.config import RenderConfig, interactive_config

    cfg = interactive_config()
    assert (cfg.width, cfg.height, cfg.num_rays) == (1920, 1080, 1 << 17)
    assert cfg.fuse_step_chains == "auto" and cfg.max_bounces == 5
    cfg = interactive_config(width=640, height=360, max_bounces=3,
                             fuse_step_chains="off", mis="on")
    assert (cfg.width, cfg.height, cfg.max_bounces) == (640, 360, 3)
    assert cfg.fuse_step_chains == "off" and cfg.mis == "on"
    for field in ("use_packet_kernel", "use_accum_kernel",
                  "packet_kernel_mode", "use_kernel_normals",
                  "adaptive_connect", "adaptive_connect_frac"):
        assert not hasattr(RenderConfig(), field)
        with pytest.raises(TypeError):
            interactive_config(**{field: "on"})
