"""The port's preview server, driven over HTTP as a browser would: the cases
of tests/test_preview.py on the port (the same inline scene, on the CPU),
the save hotkey, and the orbit camera's arrays after a sequence of
set_orbit / pan / zoom held bit for bit to the JAX Renderer's."""

import json
import textwrap
import time
import urllib.request

import numpy as np
import pytest
import torch

from pathtracer_tpu.integrator.render import Renderer as JaxRenderer
from pathtracer_tpu_torch.integrator.render import Renderer
from pathtracer_tpu_torch.preview.server import start_preview_thread
from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode
from pathtracer_tpu_torch.utils.image_io import read_png
from tests.test_preview import SCENE


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads (see tests/test_torch_schedule.py)."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture()
def scene(tmp_path):
    path = tmp_path / "p.txt"
    path.write_text(textwrap.dedent(SCENE))
    return path


@pytest.fixture()
def preview(scene):
    state, server, thread = start_preview_thread(
        Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.MIS), device="cpu"),
        port=0, chunk=1)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield state, base
    state.running = False
    server.shutdown()
    thread.join(timeout=60)


def get(base, path, timeout=30):
    return urllib.request.urlopen(base + path, timeout=timeout)


def wait_for(pred, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def stats(base):
    return json.loads(get(base, "/stats.json").read() or b"{}")


class TestPreviewServer:
    def test_page_and_frame(self, preview):
        state, base = preview
        assert b"pathtracer_tpu" in get(base, "/").read()
        png = b""

        def frame():
            nonlocal png
            png = get(base, "/frame.png").read()
            return png.startswith(b"\x89PNG")

        assert wait_for(frame)

    def test_stats_progress(self, preview):
        state, base = preview
        assert wait_for(lambda: stats(base).get("iteration", 0) >= 2)
        s = stats(base)
        assert s["mode"] == "MIS"
        assert s["resolution"] == "32x32"

    def test_orbit_resets_accumulation(self, preview):
        state, base = preview
        resets0 = state.accum_resets
        get(base, "/orbit?dtheta=10&dphi=-15").read()
        # wait on events (pose and reset counter): the iteration count
        # advances again at once after a reset
        assert wait_for(lambda: abs(state.renderer.camera.theta - 10.0) < 1e-3
                        and state.accum_resets > resets0)

    def test_zoom_and_pan(self, preview):
        state, base = preview
        pos0 = np.array(state.renderer.camera.position)
        view0 = np.array(state.renderer.camera.view)
        resets0 = state.accum_resets
        get(base, "/zoom?dy=0.5").read()
        assert wait_for(lambda: state.accum_resets > resets0)
        pos1 = np.array(state.renderer.camera.position)
        # dolly: moved opposite the view by 0.5
        np.testing.assert_allclose(pos1, pos0 - 0.5 * view0, atol=1e-5)

        resets1 = state.accum_resets
        get(base, "/pan?dx=100&dy=0").read()
        assert wait_for(lambda: state.accum_resets > resets1)
        pos2 = np.array(state.renderer.camera.position)
        # pan: -dx * ground-projected right * 0.01
        right = np.array(state.renderer.camera.right)
        right[1] = 0.0
        right /= np.linalg.norm(right)
        np.testing.assert_allclose(pos2, pos1 - 1.0 * right, atol=1e-5)

    def test_live_traced_depth(self, preview):
        state, base = preview
        assert wait_for(lambda: stats(base).get("traced depth", 0) > 0)
        assert 1 <= stats(base)["traced depth"] <= state.renderer.static.trace_depth + 1

    def test_mode_switch(self, preview):
        state, base = preview
        old = state.renderer
        get(base, "/mode?m=0").read()
        assert wait_for(lambda: stats(base).get("mode") == "BSDF")
        r = state.renderer
        assert r is not old and r.device.type == "cpu"
        assert (r.width, r.height, r.static.trace_depth) == (32, 32, 3)
        assert r.camera is old.camera

    def test_save_writes_the_png(self, preview, tmp_path, monkeypatch):
        state, base = preview
        monkeypatch.chdir(tmp_path)
        get(base, "/save").read()
        out = tmp_path / "preview.preview.png"
        assert wait_for(lambda: out.exists() and out.stat().st_size > 0)
        assert wait_for(lambda: read_png(out).shape == (32, 32, 3), timeout=10)


def test_orbit_camera_matches_jax(scene):
    """After one sequence of set_orbit, pan and zoom, the port's camera
    arrays are bitwise the JAX Renderer's."""
    port = Renderer(scene, device="cpu")
    ref = JaxRenderer(scene)
    for r in (port, ref):
        r.set_orbit(12.5, -30.0)
        r.pan(40.0, -25.0)
        r.zoom(0.3)
        r.set_orbit(-20.0, 15.0)
    for got, want in zip(port.camera.as_arrays(), ref.camera.as_arrays()):
        np.testing.assert_array_equal(got, want)
    assert port.cam_position == ref.cam_position
    assert port.iteration == ref.iteration == 0
