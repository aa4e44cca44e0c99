"""CLI smoke tests (render / bench / bvh-debug) at CPU-test sizes.

The CLI is the reference's app-shell equivalent (main.cpp + the
PERFORMANCE_TEST and BVH_DEBUG preprocessor modes, SURVEY.md C13/C14);
these tests pin the argument plumbing and the PNG/JSON outputs, which no
other test exercised end-to-end."""

import json
import os

import numpy as np
import pytest

from tyrant_tpu import cli

CUBE = "/root/reference/PathTracer/Data/cube.ply"


def _png_ok(path, size=None):
    assert os.path.exists(path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    from PIL import Image
    with Image.open(path) as im:
        im.load()
        if size is not None:
            assert im.size == size


def test_cli_render_spheres(tmp_path, capsys):
    out = tmp_path / "demo.png"
    cli.main(["render", "--width", "64", "--height", "48", "--rays", "2048",
              "--steps", "4", "--camera", "0", "-170", "40", "0", "-0.10",
              "--aovs", str(tmp_path / "f"), "--out", str(out)])
    _png_ok(out, size=(64, 48))
    _png_ok(tmp_path / "f_albedo.png", size=(64, 48))
    _png_ok(tmp_path / "f_normal.png", size=(64, 48))
    depth = np.load(tmp_path / "f_depth.npy")
    assert depth.shape == (48, 64) and np.isfinite(depth).all()
    assert depth.min() > 0  # camera outside all geometry


def test_cli_render_auto_exposure(tmp_path, capsys):
    out = tmp_path / "auto.png"
    cli.main(["render", "--width", "32", "--height", "24", "--rays", "1024",
              "--steps", "3", "--exposure", "auto", "--tonemap", "aces",
              "--camera", "0", "-170", "40", "0", "-0.10",
              "--out", str(out)])
    _png_ok(out, size=(32, 24))


def test_cli_render_aov_exr(tmp_path):
    out = tmp_path / "demo.png"
    cli.main(["render", "--width", "48", "--height", "32", "--rays", "1024",
              "--steps", "2", "--camera", "0", "-170", "40", "0", "-0.10",
              "--aovs", str(tmp_path / "f"), "--aov-format", "exr",
              "--out", str(out)])
    from tyrant_tpu.utils.exr import read_exr
    alb = read_exr(str(tmp_path / "f_albedo.exr"))
    nrm = read_exr(str(tmp_path / "f_normal.exr"))
    dep = read_exr(str(tmp_path / "f_depth.exr"))
    assert alb.shape[:2] == (32, 48) and np.isfinite(alb).all()
    # normals keep their sign in the float export (the PNG path remaps)
    assert nrm.min() < -0.1
    # depth is exact float32 (half=False), replicated across channels
    assert np.array_equal(dep[:, :, 0], dep[:, :, 1])
    assert np.isfinite(dep).all() and dep.min() > 0


def test_cli_render_mesh(tmp_path):
    if not os.path.exists(CUBE):
        pytest.skip("reference cube.ply unavailable")
    out = tmp_path / "cube.png"
    cli.main(["render", "--scene", CUBE, "--width", "48", "--height", "32",
              "--rays", "1024", "--steps", "3", "--builder", "numpy",
              "--out", str(out)])
    _png_ok(out)


def test_cli_bench_json(tmp_path, capsys):
    txt = tmp_path / "Performance.txt"
    cli.main(["bench", "--width", "32", "--height", "24", "--rays", "1024",
              "--seconds", "0.05", "--json", "--txt", str(txt)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    d = json.loads(line)
    assert len(d["poses"]) == 3
    assert d["total_mrays_per_s"] > 0
    assert np.isfinite(d["avg_frame_ms"])
    body = txt.read_text()
    # reference-style Performance.txt (performance_measure.cpp:24-42 with
    # the ms/seconds mislabel fixed)
    assert body.count("Average frame time") == 3
    assert "Min frame time" in body and "Max frame time" in body


def test_cli_bvh_debug(tmp_path):
    if not os.path.exists(CUBE):
        pytest.skip("reference cube.ply unavailable")
    out = tmp_path / "heat.png"
    cli.main(["bvh-debug", "--scene", CUBE, "--width", "48", "--height",
              "32", "--rays", "1024", "--builder", "numpy",
              "--camera", "0", "-6", "2", "0", "-0.2", "--out", str(out)])
    _png_ok(out)


def test_cli_checkpoint_resume_exact(tmp_path):
    """render 3 + resume 3 == straight 6, bit-for-bit (the checkpoint
    claim: rays/RNG/accumulation restore exactly)."""
    import numpy as np
    from tyrant_tpu.checkpoint import load_state
    ck = str(tmp_path / "st.npz")
    common = ["render", "--width", "32", "--height", "24", "--rays", "1024",
              "--camera", "0", "-170", "40", "0", "-0.10"]
    cli.main(common + ["--steps", "3", "--checkpoint", ck,
                       "--out", str(tmp_path / "a.png")])
    st3, meta = load_state(ck)
    assert meta["steps"] == 3 and meta["pose"][2] == 40.0
    # resume WITHOUT --camera: the saved pose is adopted
    cli.main(["render", "--width", "32", "--height", "24", "--rays", "1024",
              "--steps", "6", "--checkpoint", ck,
              "--out", str(tmp_path / "b.png")])
    st6, meta6 = load_state(ck)
    assert meta6["steps"] == 6
    ck2 = str(tmp_path / "st2.npz")
    cli.main(common + ["--steps", "6", "--checkpoint", ck2,
                       "--out", str(tmp_path / "c.png")])
    st6b, _ = load_state(ck2)
    assert np.array_equal(np.asarray(st6.accum), np.asarray(st6b.accum))
    assert int(st6.frame) == int(st6b.frame)


def test_cli_checkpoint_mismatch_fails(tmp_path):
    ck = str(tmp_path / "st.npz")
    cli.main(["render", "--width", "32", "--height", "24", "--rays", "1024",
              "--steps", "2", "--checkpoint", ck,
              "--out", str(tmp_path / "a.png")])
    with pytest.raises(SystemExit, match="same --width"):
        cli.main(["render", "--width", "64", "--height", "24", "--rays",
                  "1024", "--steps", "2", "--checkpoint", ck,
                  "--out", str(tmp_path / "b.png")])
    with pytest.raises(SystemExit, match="different --camera"):
        cli.main(["render", "--width", "32", "--height", "24", "--rays",
                  "1024", "--steps", "2", "--checkpoint", ck,
                  "--camera", "5", "5", "5", "0", "0",
                  "--out", str(tmp_path / "c.png")])


def test_cli_info(capsys):
    """`info` prints scene/BVH/light/memory facts without rendering (the
    reference prints BVH stats + scene name at load, bvh.cpp:27-42)."""
    if not os.path.exists(CUBE):
        pytest.skip("reference cube.ply unavailable")
    cli.main(["info", "--scene", CUBE, "--builder", "numpy"])
    out = capsys.readouterr().out
    assert "bvh.nodes:" in out
    assert "spheres: 7" in out
    assert "lights:" in out
    assert "traversal: xla on cpu" in out
    assert "render config:" in out


def test_cli_dof_autofocus(tmp_path, capsys):
    """--focus-at sets the focus plane from the primary-hit depth; --lens-
    radius/--focal-distance plumb the reference's DoF sliders (world
    units: the slider's 3x scale is unapplied, kernel.cu:286)."""
    out = tmp_path / "dof.png"
    # default 7-sphere scene; aim at the floor so the focus pixel hits
    cli.main(["render", "--width", "48", "--height", "32", "--rays", "1024",
              "--steps", "2", "--camera", "0", "-170", "40", "0", "-0.10",
              "--lens-radius", "2.0", "--focus-at", "0.5", "0.8",
              "--out", str(out)])
    _png_ok(out, size=(48, 32))
    err = capsys.readouterr().err
    assert "autofocus: depth" in err

    # --focal-distance is a WORLD distance: the camera field divides out
    # the slider scale
    import argparse
    ns = argparse.Namespace(
        scene=None, width=8, height=8, rays=64, bounces=2, no_spheres=False,
        sun=(0.05, 0.3), camera=None, scale=1.0, clamp=0.0, denoise=False,
        tonemap="reinhard", exposure=1.0, envmap=None, adaptive=False,
        mis=False, sampler="xorshift", seed=0, light_sampling="uniform",
        fog=False, projection="perspective", texture_filter="bilinear",
        builder="numpy", lens_radius=0.5, focal_distance=30.0)
    cfg, scene, cam = cli._build(ns)
    assert cam.lens_radius == 0.5
    np.testing.assert_allclose(
        cam.focal_distance * cfg.focal_distance_scale, 30.0)


def test_cli_autofocus_sky_warns(tmp_path, capsys):
    out = tmp_path / "sky.png"
    cli.main(["render", "--no-spheres", "--width", "32", "--height", "24",
              "--rays", "512", "--steps", "1",
              "--lens-radius", "1.0", "--focus-at", "0.5", "0.1",
              "--out", str(out)])
    _png_ok(out)
    assert "hits the sky" in capsys.readouterr().err


def test_cli_render_look_at(tmp_path, capsys):
    """--look-at re-aims the camera: pointing straight at the green light
    sphere (0,-80,120) from below makes the top rows bright."""
    out = tmp_path / "look.png"
    cli.main(["render", "--width", "32", "--height", "24",
              "--rays", "4096", "--steps", "3",
              "--camera", "0", "-80", "60", "0", "0",
              "--look-at", "0", "-80", "120", "--out", str(out)])
    _png_ok(out, size=(32, 24))
    from PIL import Image
    img = np.asarray(Image.open(out), np.float32)
    # the emissive sphere is dead ahead: the centre pixels saturate at
    # the tonemapped emission, well above every corner
    corners = np.mean([img[:4, :4].mean(), img[:4, -4:].mean(),
                       img[-4:, :4].mean(), img[-4:, -4:].mean()])
    assert img[10:14, 14:18].mean() > 1.5 * corners
