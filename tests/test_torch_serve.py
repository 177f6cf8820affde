"""The port's HTTP service (uegan_tpu_torch/serve/app.py) on the CPU.

Every test of tests/test_serve.py on the port's server, plus its parity
with the JAX package on the same weights: the served PNG against JAX's
``make_fast_eval(..., u8_output=True)`` on the same resized input (the JAX
server's forward), NIMA's probabilities against JAX's NIMA on the same
``.pth``.  The server is the JAX server's: the default generator (cd 32,
bfloat16, the packed forward) at ``test_img_size`` 32, here from a
reference ``.pth`` of N(0, 1/fan_in) weights from a numpy seed.
"""

import http.client
import io
import json
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from uegan_tpu.config import Config as JaxConfig
from uegan_tpu.convert.torch_import import import_generator, import_nima
from uegan_tpu.data.pipeline import device_normalize
from uegan_tpu.infer.packed import make_fast_eval as jax_make_fast_eval
from uegan_tpu.metrics.nima import prepare_image_np as jax_prepare_image_np
from uegan_tpu.models.nima import NIMA as JaxNIMA
from uegan_tpu.train.state import build_models as jax_build_models
from uegan_tpu_torch.serve import app
from uegan_tpu_torch.serve.app import _MicroBatcher, create_server

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this file runs (the suite runs several workers
    on a few cores), restored after it so other files keep their setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(generator .pth, its numpy state dict, NIMA .pth): the default
    generator's widths, N(0, 1/fan_in) from a numpy seed; NIMA seeded."""
    from uegan_tpu_torch.metrics.nima import init_nima
    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.models.initializers import fan_in_normal_state
    from uegan_tpu_torch.models.nima import save_nima_pth

    root = tmp_path_factory.mktemp("serve_weights")
    sd = fan_in_normal_state(Generator(conv_dim=32), seed=1990)
    g_pth = str(root / "UEGAN-FiveK_rahinge_92.pth")
    torch.save({"G_net": {k: torch.from_numpy(v) for k, v in sd.items()}}, g_pth)
    nima_pth = save_nima_pth(init_nima("", rng_seed=7, device="cpu"), str(root / "nima.pth"))
    return g_pth, sd, nima_pth


def _start(**kw):
    srv = create_server(host="127.0.0.1", port=0, test_img_size=SIZE, device="cpu", **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


def _stop(srv) -> None:
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def server(weights):
    g_pth, _, nima_pth = weights
    srv = _start(generator_ckpt=g_pth, nima_weights=nima_pth)
    yield srv
    _stop(srv)


def _png_bytes(rng, size=64, width=None):
    arr = (rng.random((size, width or size, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def _post(srv, route: str, body: bytes, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=timeout)
    conn.request("POST", route, body=body)
    r = conn.getresponse()
    return r.status, r.getheader("Content-Type"), r.read()


def _resized(png: bytes) -> np.ndarray:
    """The served input: RGB, PIL bilinear to test_img_size, uint8."""
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB").resize((SIZE, SIZE),
                                                                         Image.BILINEAR))


def _jax_served(sd: dict, qi: str, x_u8: np.ndarray) -> np.ndarray:
    """The JAX server's forward on ``x_u8`` (N, H, W, 3): its default
    generator from the same weights, make_fast_eval with u8 output after
    device_normalize, calibrated (int8) on JAX's seeded batch."""
    cfg = JaxConfig(quantized_inference=qi)
    g_model = jax_build_models(cfg)[0]
    params = import_generator(sd)["params"]
    bundle = SimpleNamespace(g_model=g_model, config=cfg)
    base = jax_make_fast_eval(bundle, params, u8_output=True)
    fn = jax.jit(lambda p, x: base(p, None, device_normalize(x)))
    return np.asarray(fn(params, jnp.asarray(x_u8)))


def test_info_endpoint(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
    conn.request("GET", "/")
    r = conn.getresponse()
    assert r.status == 200
    body = json.loads(r.read())
    assert body["endpoints"] == ["/api/get_scores", "/api/enhance"]


def test_get_scores(server, rng):
    status, ctype, body = _post(server, "/api/get_scores", _png_bytes(rng))
    assert (status, ctype) == (200, "application/json")
    body = json.loads(body)
    assert 1.0 <= body["mean_score"] <= 10.0
    assert len(body["scores"]) == 10
    np.testing.assert_allclose(sum(body["scores"]), 1.0, rtol=1e-4)


def test_scores_match_jax_nima(server, weights, rng):
    """The served probabilities (6 decimals) within 2e-5 of JAX's NIMA (f32)
    on the same .pth and JAX's own preparation of the same image; the mean
    and std are the JAX server's sums over them."""
    png = _png_bytes(rng, 300, 260)
    status, _, body = _post(server, "/api/get_scores", png)
    assert status == 200
    body = json.loads(body)
    x = jax_prepare_image_np(Image.open(io.BytesIO(png)))[None]
    want = np.asarray(jax.jit(lambda v, b: JaxNIMA().apply(v, b, train=False))(
        import_nima(weights[2]), jnp.asarray(x)))[0]
    np.testing.assert_allclose(body["scores"], want, atol=2e-5, rtol=0)
    mean = float((want * np.arange(1, 11)).sum())
    assert abs(body["mean_score"] - mean) <= 2e-4


def test_enhance_endpoint(server, rng):
    """POST image -> enhanced PNG at test_img_size through the packed path."""
    status, ctype, body = _post(server, "/api/enhance", _png_bytes(rng))
    assert (status, ctype) == (200, "image/png")
    assert Image.open(io.BytesIO(body)).size == (SIZE, SIZE)


def test_enhance_matches_jax_server_forward(server, weights, rng):
    """The served PNG within one gray level of the JAX server's forward
    (make_fast_eval, u8 output, bf16) on the same resized input and weights."""
    png = _png_bytes(rng, 48, 80)
    status, _, body = _post(server, "/api/enhance", png)
    assert status == 200
    got = np.asarray(Image.open(io.BytesIO(body))).astype(np.int16)
    want = _jax_served(weights[1], "", _resized(png)[None])[0].astype(np.int16)
    assert np.abs(got - want).max() <= 1


def test_enhance_int8_mode_matches_jax(weights, rng):
    """--quantized_inference int8 routes enhancement through the int8
    forward, calibrated on JAX's seeded batch as the JAX server's is; the
    PNG is at least 40 dB from the JAX server's int8 forward."""
    srv = _start(generator_ckpt=weights[0], quantized_inference="int8")
    try:
        png = _png_bytes(rng)
        status, _, body = _post(srv, "/api/enhance", png)
        assert status == 200
        got = np.asarray(Image.open(io.BytesIO(body))).astype(np.float64)
        assert got.shape == (SIZE, SIZE, 3)
    finally:
        _stop(srv)
    want = _jax_served(weights[1], "int8", _resized(png)[None])[0].astype(np.float64)
    mse = float(((got - want) ** 2).mean())
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 40.0


def test_orbax_generator_ckpt_fails_at_startup(tmp_path):
    """The JAX server serves an orbax directory; the port refuses it at
    startup and names the command that exports it to a .pth."""
    ckpt = tmp_path / "UEGAN-FiveK_rahinge_9"
    ckpt.mkdir()
    with pytest.raises(NotImplementedError, match="orbax_to_pth.py --ckpt"):
        create_server(host="127.0.0.1", port=0, device="cpu", generator_ckpt=str(ckpt))


def test_missing_ckpt_serves_the_seeded_generator(rng):
    """Without --generator_ckpt the server enhances with the Tester's seeded
    default generator (JAX serves its PRNGKey(0) init): the PNG equals that
    generator's make_fast_eval on the resized input."""
    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.infer.packed import make_fast_eval
    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.models.initializers import init_weights
    from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8

    srv = _start()
    try:
        png = _png_bytes(rng)
        status, _, body = _post(srv, "/api/enhance", png)
    finally:
        _stop(srv)
    assert status == 200
    cfg = Config()
    g = Generator(dtype=torch.bfloat16)
    init_weights(g, cfg.init_type, 0.02, torch.Generator().manual_seed(cfg.seed))
    with torch.inference_mode():
        want = quantize_u8(make_fast_eval(g.eval(), cfg)(
            normalize_u8(torch.from_numpy(_resized(png)[None].copy())))).numpy()[0]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))), want)


def test_microbatcher_groups_and_orders():
    """Concurrent submits share calls; each caller gets its own result back
    (order-preserving distribution), padding never leaks out; the calls run
    under inference mode on the worker thread."""
    calls, modes = [], []

    def run(arrs):
        calls.append(arrs.shape[0])
        modes.append(torch.is_inference_mode_enabled())
        return arrs * 2.0

    mb = _MicroBatcher(run, window_ms=200.0, max_batch=8)
    results = {}

    def worker(i):
        results[i] = mb.submit(np.full((4,), float(i), np.float32))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 6
    for i in range(6):
        np.testing.assert_array_equal(results[i], np.full((4,), 2.0 * i, np.float32))
    assert mb.calls == len(calls) and len(calls) < 6
    assert all(c in (1, 2, 4, 8) for c in calls)
    assert all(modes)
    worker_thread = mb._worker
    mb.close()
    assert not worker_thread.is_alive()


def test_microbatcher_propagates_errors():
    def boom(arrs):
        raise RuntimeError("device on fire")

    mb = _MicroBatcher(boom, window_ms=1.0, max_batch=4)
    with pytest.raises(RuntimeError, match="device on fire"):
        mb.submit(np.zeros((2,), np.float32))
    # the worker survives a failed batch and serves the next one
    mb.run_batch = lambda arrs: arrs + 1.0
    np.testing.assert_array_equal(
        mb.submit(np.zeros((2,), np.float32)), np.ones((2,), np.float32)
    )
    mb.close()


def test_concurrent_enhance_requests(server, rng):
    """Simultaneous /api/enhance requests all come back right through the
    micro-batched path: each PNG equals that input's single-request PNG
    within one gray level (a batch of 4 against one of 1)."""
    bodies = [_png_bytes(rng) for _ in range(4)]  # rng isn't thread-safe
    singles = [np.asarray(Image.open(io.BytesIO(_post(server, "/api/enhance", b)[2])))
               for b in bodies]
    outs = {}

    def hit(i):
        status, _, body = _post(server, "/api/enhance", bodies[i])
        outs[i] = (status, np.asarray(Image.open(io.BytesIO(body))))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert sorted(outs) == [0, 1, 2, 3]
    for i, (status, img) in outs.items():
        assert status == 200 and img.shape == (SIZE, SIZE, 3)
        assert np.abs(img.astype(np.int16) - singles[i]).max() <= 1


def test_device_work_runs_in_inference_mode(server, weights, rng):
    """The batcher's worker and a --keep_aspect request thread both run the
    forward under inference mode: grad mode is per thread, and on a card
    kernels C and D refuse to run where autograd is on."""
    seen = []

    def wrap(models):
        run = models._run_u8

        def spy(arrs):
            seen.append(torch.is_inference_mode_enabled())
            return run(arrs)
        models._run_u8 = spy

    wrap(server.models)
    try:
        assert _post(server, "/api/enhance", _png_bytes(rng))[0] == 200
    finally:
        del server.models._run_u8
    native = _start(generator_ckpt=weights[0], keep_aspect=True)
    try:
        assert _post(native, "/api/enhance", _png_bytes(rng))[0] == 200  # builds the enhancer
        wrap(native.models)
        assert _post(native, "/api/enhance", _png_bytes(rng, 40, 56))[0] == 200
    finally:
        _stop(native)
    assert seen == [True, True]


def test_kernel_library_builds_once_under_concurrent_first_use(monkeypatch):
    """Request threads that launch their first kernels at once wait for one
    build of the library (ops/_build.py:load), not one nvcc run each."""
    import ctypes

    from uegan_tpu_torch.ops import _build

    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        threading.Event().wait(0.05)
        return "libuegan_kernels-test.so"

    class FakeLib:
        def __getattr__(self, name):
            return SimpleNamespace()

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    gate = threading.Barrier(16)
    libs = []

    def first_launch():
        gate.wait()
        libs.append(_build.load())

    threads = [threading.Thread(target=first_launch) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(libs) == 16 and all(lib is libs[0] for lib in libs)


def test_bad_generator_ckpt_fails_at_startup(tmp_path):
    """A typo'd --generator_ckpt aborts server construction, rather than
    serving the seeded weights or failing the first request."""
    with pytest.raises(FileNotFoundError):
        create_server(host="127.0.0.1", port=0, test_img_size=SIZE, device="cpu",
                      generator_ckpt=str(tmp_path / "nope_92"))


def test_refuses_to_start_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    """The device is the card unless --platform cpu or UEGAN_TORCH_DEVICE=cpu
    says otherwise; with no CUDA the server does not start; --platform takes
    '', cpu, gpu and cuda and nothing else."""
    monkeypatch.delenv("UEGAN_TORCH_DEVICE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_server(host="127.0.0.1", port=0)
    got = []
    monkeypatch.setattr(app, "run_server", lambda *a, **kw: got.append(kw["device"]))
    for flag in ("", "cpu", "gpu", "cuda"):
        app.main(["--platform", flag])
    assert got == [None, "cpu", "cuda", "cuda"]
    with pytest.raises(ValueError, match="--platform"):
        app.main(["--platform", "tpu"])
    monkeypatch.setenv("UEGAN_TORCH_DEVICE", "cpu")
    srv = create_server(host="127.0.0.1", port=0)
    try:
        assert srv.models.device == torch.device("cpu")
    finally:
        srv.server_close()


def test_invalid_image_400(server):
    status, _, body = _post(server, "/api/get_scores", b"not an image")
    assert status == 400
    assert "error" in json.loads(body)


def test_unknown_route_404(server):
    assert _post(server, "/api/nope", b"")[0] == 404


def test_enhance_keep_aspect_native_size(weights, rng):
    """--keep_aspect serves native-resolution enhancement: a non-square,
    non-/16 input comes back at its own size, not the square resize."""
    srv = _start(generator_ckpt=weights[0], keep_aspect=True)
    try:
        status, _, body = _post(srv, "/api/enhance", _png_bytes(rng, 40, 56))
        assert status == 200
        assert Image.open(io.BytesIO(body)).size == (56, 40)  # PIL size is (w, h)
    finally:
        _stop(srv)
