"""The port's generate CLI and PhotoVerseService on the CPU, on the tiny
diffusers-layout directory of tests/test_cli_e2e.py: PNGs out of the CLI,
the multi-GPU flags at one rank and their validation, and the service over real HTTP (round trip, coalescing
with per-request seeds, an ancestral sampler, padding, backpressure, drain,
a mixed burst). 2 steps at 32px, f32.

Pixel limits are in uint8 steps: a coalesced request equals its solo run
within 2/255 (another batch size may take other library algorithms; the
JAX package's test allows the same), and two seeds differ by more.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from photoverse_tpu.cli import generate as jgen
from photoverse_tpu.cli.serve import PhotoVerseService as JaxService
from photoverse_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from photoverse_tpu_torch.cli import generate as tgen
from photoverse_tpu_torch.cli.serve import PhotoVerseService, ServiceOverloaded, build_parser, make_handler
from photoverse_tpu_torch.core.schedulers import make_solver
from photoverse_tpu_torch.engine.inference import run_inference
from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer
from tests.test_cli_e2e import _make_checkpoint
from tests.torch_threads import worker_threads  # noqa: F401

SAME = 2  # uint8 steps between a coalesced request and its solo run


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    root = _make_checkpoint(d)
    face = d / "face.jpg"
    Image.fromarray((np.random.RandomState(0).rand(64, 64, 3) * 255).astype(np.uint8)).save(face)
    return d, root, face


def _service(root, *extra):
    common = ["--model_path", root, "--resolution", "32", "--default_steps", "2",
              "--encoder_layers_idx", "1", "2", "3", "4", "--port", "0", "--cpu"]
    return PhotoVerseService(build_parser().parse_args(common + list(extra)))


class _Served:
    def __init__(self, service, cls):
        self.service = service
        self.server = cls(("127.0.0.1", 0), make_handler(service))
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def post(self, body):
        r = urllib.request.urlopen(
            urllib.request.Request(
                f"http://127.0.0.1:{self.port}/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}),
            timeout=300)
        return json.loads(r.read())

    def health(self):
        return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{self.port}/healthz").read())


@pytest.fixture(scope="module")
def seq(ws):
    s = _Served(_service(ws[1]), HTTPServer)
    yield s
    s.server.shutdown()


@pytest.fixture(scope="module")
def bat(ws):
    # max_batch 2: a pair dispatches the moment both requests are queued
    s = _Served(_service(ws[1], "--dynamic_batching", "--batch_wait_ms", "2000", "--max_batch", "2"),
                ThreadingHTTPServer)
    yield s
    s.server.shutdown()


@pytest.fixture(scope="module")
def base(ws):
    img_b64 = base64.b64encode(ws[2].read_bytes()).decode()
    return {"image_b64": img_b64, "prompt": "the photo of a {}", "steps": 2, "guidance_scale": 2.0}


def pixels(resp, i=0):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(resp["images_b64"][i]))), np.int32)


def fire_all(served, bodies):
    out = [None] * len(bodies)

    def fire(i):
        out[i] = served.post(bodies[i])

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_generate_cli_writes_pngs(ws):
    d, root, face = ws
    results = d / "out"
    tgen.main([
        "--model_path", root, "--checkpoint_path", "", "--input_image_path", str(face),
        "--results_dir", str(results), "--output_image_path", "gen", "--num_timesteps", "3",
        "--resolution", "32", "--guidance_scale", "2.0", "--negative_prompt", "bad photo",
        "--num_of_samples", "2", "--text", "a photo of a {}", "the photo of {}",
        "--encoder_layers_idx", "1", "2", "3", "4", "--seed", "7", "--cpu",
    ])
    imgs = [np.asarray(Image.open(results / f"gen{i}.png")) for i in range(4)]  # 2 templates x 2 samples
    assert all(im.shape == (32, 32, 3) and im.dtype == np.uint8 for im in imgs)
    assert not (results / "gen4.png").exists()
    assert np.abs(imgs[0].astype(int) - imgs[1].astype(int)).max() > 0  # two samples, two noises


def test_generate_cli_mask_noised_image_and_ancestral_sampler(ws):
    d, root, face = ws
    mask = d / "mask.png"
    Image.fromarray(np.concatenate([np.zeros((32, 16), np.uint8), np.full((32, 16), 255, np.uint8)], 1)).save(mask)
    common = ["--model_path", root, "--checkpoint_path", "", "--input_image_path", str(face),
              "--num_timesteps", "2", "--resolution", "32", "--encoder_layers_idx", "1", "2", "3", "4",
              "--seed", "5", "--cpu", "--scheduler", "euler_a", "--from_noised_image"]
    tgen.main(common + ["--results_dir", str(d / "m0")])
    tgen.main(common + ["--results_dir", str(d / "m0b")])
    tgen.main(common + ["--results_dir", str(d / "m1"), "--ip_adapter_mask_path", str(mask)])
    a, b, c = (np.asarray(Image.open(d / n / "generated_image0.png"), np.int32) for n in ("m0", "m0b", "m1"))
    assert np.array_equal(a, b)  # one seed, one image
    assert np.abs(a - c).max() > 0  # the mask acts


def _gen_argv(ws, out, *flags):
    d, root, face = ws
    return (["--model_path", root, "--checkpoint_path", "", "--input_image_path", str(face), "--results_dir",
             str(d / out), "--num_timesteps", "2", "--resolution", "32", "--encoder_layers_idx", "1", "2", "3", "4",
             "--seed", "7", "--cpu"] + list(flags))


@pytest.fixture(scope="module")
def gen_plain(ws):
    tgen.main(_gen_argv(ws, "plain"))
    return np.asarray(Image.open(ws[0] / "plain" / "generated_image0.png"))


# the multi-GPU flags run since parallel/ was ported (the cases asserted
# their refusal): at one rank they print the JAX CLI's warning and run the
# one-process pipeline; at WORLD_SIZE 3 a model the mode cannot split exits
# with validate_tp's / validate_sp's message before any group opens
# (tests/test_torch_parallel_cli.py runs the modes on two ranks)
@pytest.mark.parametrize("flags,world,said", [
    (["--sharding", "spatial"], 1, "WARNING: --sharding spatial requires >1 device (found 1); running single-device"),
    (["--data_parallel"], 1, "WARNING: --sharding data requires >1 device (found 1); running single-device"),
    (["--sharding", "tensor", "--model_parallel", "2"], 1,
     "WARNING: --sharding tensor requires >1 device (found 1); running single-device"),
    (["--data_parallel", "--sharding", "spatial"], 3, "spatial axis 3 must divide the deepest latent height 8"),
    (["--sharding", "tensor", "--int8_conditioning"], 3, "tensor_parallel=3 must divide num_heads=2"),
])
def test_generate_cli_refuses_unported_flags(ws, gen_plain, capsys, monkeypatch, flags, world, said):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    out = "flagged_" + "_".join(f.strip("-") for f in flags)
    if world > 1:
        with pytest.raises(SystemExit, match=said):
            tgen.main(_gen_argv(ws, out, *flags))
        assert not (ws[0] / out).exists()
        return
    tgen.main(_gen_argv(ws, out, *flags))
    assert said in capsys.readouterr().out
    np.testing.assert_array_equal(np.asarray(Image.open(ws[0] / out / "generated_image0.png")), gen_plain)


def test_generate_cli_early_exits(ws):
    d, root, face = ws
    with pytest.raises(SystemExit, match="karras_sigmas is invalid"):
        tgen.main(["--model_path", root, "--input_image_path", str(face), "--cpu", "--karras_sigmas",
                   "--scheduler", "ddim"])
    with pytest.raises(SystemExit, match="input_image_path is required"):
        tgen.main(["--model_path", root, "--cpu"])
    with pytest.raises(SystemExit, match="checkpoint not found"):
        tgen.main(["--model_path", root, "--input_image_path", str(face), "--cpu",
                   "--checkpoint_path", str(d / "nope.pt")])


def _assert_same_example(got: dict, want: dict):
    """Key for key the same arrays (dtype, shape, every element)."""
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None or k == "text":
            assert got[k] == w, k
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("template,n,negative,mode", [
    ("a photo of a {}", None, None, "path"),
    ("the photo of {}", 3, "bad photo", "path"),
    (["a photo of a {}", "the photo of {}"], None, None, "path"),
    (["a photo of a {}", "the photo of {}", "{} the"], 2, "bad photo", "path"),
    ("a photo of a {}", 2, None, "RGBA"),  # an already decoded image, not RGB
])
def test_preprocess_image_for_inference_matches_jax(ws, template, n, negative, mode):
    """The CLI's host preprocessing (several templates x samples over one
    photo, tiled negatives) is deterministic: identical to the JAX
    package's on the same photo and tokenizer files."""
    _, root, face = ws
    jtok, ttok = JaxTokenizer.from_pretrained(root), CLIPTokenizer.from_pretrained(root)
    image = str(face) if mode == "path" else Image.open(face).convert(mode)
    kw = dict(template=template, negative_prompt=negative, num_of_samples=n, size=32, clip_size=16)
    want = jgen.preprocess_image_for_inference(image, jtok, **kw)
    got = tgen.preprocess_image_for_inference(image, ttok, **kw)
    _assert_same_example(got, want)
    rows = (1 if isinstance(template, str) else len(template)) * (n or 1)
    assert got["pixel_values"].shape == (rows, 32, 32, 3) and got["pixel_values_clip"].shape == (rows, 16, 16, 3)


@pytest.mark.parametrize("req", [
    {},  # every default
    {"num_samples": 11, "seed": 5},  # clamped to --max_batch
    {"prompt": "the photo of", "steps": 7, "guidance_scale": 3, "scheduler": "euler_a_karras", "seed": 2**31},
    {"prompt": "", "negative_prompt": "bad photo", "num_samples": 2, "seed": 0},
    {"prompt": "{} the photo", "num_samples": 3, "negative_prompt": ""},
], ids=["defaults", "clamped", "no_placeholder", "empty_prompt", "leading_placeholder"])
@pytest.mark.parametrize("by_path", [False, True], ids=["b64", "path"])
def test_service_prepare_matches_jax(ws, seq, base, req, by_path):
    """`_prepare` (clamping of num_samples, the prompt fix-up, the empty
    negative, dtypes, the shape key) against the JAX service's on the same
    request body."""
    import types

    svc = seq.service
    stub = types.SimpleNamespace(args=svc.args, tokenizer=JaxTokenizer.from_pretrained(ws[1]),
                                 clip_size=svc.clip_size, _EXAMPLE_KEYS=JaxService._EXAMPLE_KEYS)
    body = dict(req, image_path=str(ws[2])) if by_path else dict(req, image_b64=base["image_b64"])
    want_ex, want_n, want_seed, want_key = JaxService._prepare(stub, body)
    got_ex, got_n, got_seed, got_key = svc._prepare(body)
    _assert_same_example(got_ex, want_ex)
    assert (got_n, got_key) == (want_n, want_key) and type(got_key[1]) is type(want_key[1])
    if "seed" in req:
        assert got_seed == want_seed == req["seed"]
    else:  # drawn from the OS: 32 bits
        assert 0 <= got_seed < 2**32 and svc._prepare(body)[2] != got_seed


# --sharding runs since parallel/ was ported (the cases asserted its
# refusal): at one rank the JAX server's warning and a one-process service
# that serves what the plain one serves; at WORLD_SIZE 3 a model the mode
# cannot split exits with validate_tp's / validate_sp's message
@pytest.mark.parametrize("flags,world,said", [
    (["--sharding", "tensor"], 1, "WARNING: --sharding tensor requires >1 device (found 1); serving single-device"),
    (["--sharding", "spatial", "--int8_conditioning"], 3, "spatial axis 3 must divide the deepest latent height 8"),
    (["--sharding", "tensor", "--native_tokenizer"], 3, "tensor_parallel=3 must divide num_heads=2"),
])
def test_serve_refuses_unported_flags(ws, base, capsys, monkeypatch, flags, world, said):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    if world > 1:
        with pytest.raises(SystemExit, match=said):
            _service(ws[1], *flags)
        return
    svc = _service(ws[1], *flags)
    assert said in capsys.readouterr().out and svc.mesh is None
    example, n, seed, key = svc._prepare(dict(base, num_samples=2, seed=6))
    np.testing.assert_array_equal(svc.submit(example, n, seed, key)["images"],
                                  _service(ws[1]).submit(example, n, seed, key)["images"])


def test_serve_int8_conditioning_and_native_tokenizer(ws, base):
    from photoverse_tpu_torch.data.native_tokenizer import NativeCLIPTokenizer

    svc = _service(ws[1], "--int8_conditioning", "--native_tokenizer")
    assert isinstance(svc.tokenizer, NativeCLIPTokenizer)
    assert svc.models.text_encoder.config.int8_dense and svc.models.vision_encoder.config.int8_dense
    served = _Served(svc, HTTPServer)
    try:
        resp = served.post(dict(base, num_samples=2, seed=4))
    finally:
        served.server.shutdown()
    assert len(resp["images_b64"]) == 2 and pixels(resp, 1).shape == (32, 32, 3)
    plain = _service(ws[1])
    ex = svc._prepare(dict(base, seed=4))[0]
    _assert_same_example(ex, plain._prepare(dict(base, seed=4))[0])  # the native ids are the Python ones


def test_entry_points_default_to_the_card(monkeypatch):
    # without --cpu both CLIs want the card, and say so where there is none
    # instead of falling back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tgen.pick_device(False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tgen.pick_device(False) == "cuda" and tgen.pick_device(True) == "cpu"
    assert build_parser().parse_args(["--model_path", "x"]).cpu is False
    assert tgen.build_parser().parse_args([]).cpu is False


def test_serve_round_trip_and_healthz(seq, base):
    health = seq.health()
    assert health["status"] == "ok" and health["dynamic_batching"] is False and health["resolution"] == 32
    resp = seq.post(dict(base, num_samples=2, seed=3))
    assert len(resp["images_b64"]) == 2 and resp["seed"] == 3 and resp["batch_rows"] == 2
    assert pixels(resp).shape == (32, 32, 3)
    again = seq.post(dict(base, num_samples=2, seed=3))
    assert np.array_equal(pixels(again, 1), pixels(resp, 1))  # a seed is an image
    assert [2, 2, 2.0, "dpm"] in seq.health()["compiled_shapes"]
    assert seq.health()["stats"]["requests"] == 2 and seq.health()["stats"]["thread_errors"] == 0
    with pytest.raises(urllib.error.HTTPError) as e:
        seq.post(dict(base, scheduler="plms"))
    assert e.value.code == 500 and "unknown scheduler" in json.loads(e.value.read())["error"]


@pytest.mark.parametrize("scheduler", ["dpm", "euler_a"])
def test_serve_coalesces_with_seeds_preserved(seq, bat, base, scheduler):
    body = dict(base, scheduler=scheduler)
    solo3, solo7 = seq.post(dict(body, seed=3)), seq.post(dict(body, seed=7))
    r3, r7 = fire_all(bat, [dict(body, seed=3), dict(body, seed=7)])
    assert r3["batch_rows"] == 2 and r7["batch_rows"] == 2  # one device batch of 2 rows
    assert np.abs(pixels(r3) - pixels(solo3)).max() <= SAME
    assert np.abs(pixels(r7) - pixels(solo7)).max() <= SAME
    assert np.abs(pixels(r3) - pixels(r7)).max() > SAME
    health = bat.health()
    assert health["dynamic_batching"] is True
    assert health["stats"]["batches"] >= 1 and health["stats"]["rows"] >= 2
    assert health["stats"]["thread_errors"] == 0


def test_serve_comparison_catches_one_step_of_another_rows_noise(ws, seq, base):
    """A mild planted fault: seed 7's row gets seed 3's ancestral noise at
    one step only (every other draw its own), the first step or a late
    one. The comparison with the solo run, at the limit the coalescing
    test uses, catches it."""
    svc = _service(ws[1], "--dynamic_batching", "--batch_wait_ms", "2000", "--max_batch", "2")
    body = dict(base, scheduler="euler_a", steps=6)
    solo7 = pixels(seq.post(dict(body, seed=7)))
    prepared = [svc._prepare(dict(body, seed=s)) for s in (3, 7)]

    def pair():
        out = [None, None]
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, svc.submit(*prepared[i])))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert [r["batch_rows"] for r in out] == [2, 2]
        return out[1]["images"][0].astype(np.int32)

    assert np.abs(pair() - solo7).max() <= SAME
    real = svc._make_row_noise
    readings = []
    for at in (0, 3):  # read 85 and 10 of 255 (the noise of step 4, sigma 0.03, moves no uint8 step)
        def one_step_wrong(seed, n, solver, at=at):
            z = real(seed, n, solver).clone()
            if seed == 7:
                z[at] = real(3, n, solver)[at]
            return z

        svc._make_row_noise = one_step_wrong
        readings.append(int(np.abs(pair() - solo7).max()))
    assert min(readings) > 2 * SAME, readings
    assert svc.drain(30) and not svc.thread_errors


def test_serve_mixed_shapes_do_not_coalesce(bat, base):
    r2, r3 = fire_all(bat, [dict(base, seed=42, steps=2), dict(base, seed=42, steps=3)])
    assert r2["batch_rows"] == 1 and r3["batch_rows"] == 1
    assert np.abs(pixels(r2) - pixels(r3)).max() > 0


def test_serve_backpressure_and_drain(bat, base):
    assert bat.service.drain(timeout_s=30) is True  # idle: drained
    rejected = bat.health()["stats"]["rejected"]
    bat.service.args.max_queue = 0
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            bat.post(dict(base, seed=99))
        assert e.value.code == 503 and "queue full" in json.loads(e.value.read())["error"]
        with pytest.raises(ServiceOverloaded):
            bat.service.submit({}, 1, 0, (2, 2.0, "dpm"))
    finally:
        bat.service.args.max_queue = 64
    assert bat.health()["stats"]["rejected"] == rejected + 2


def test_service_request_equals_one_shot_run_inference(seq, base):
    # the same prepared example through run_inference with the same seed:
    # the service's noise derivation is the one-shot path's
    svc = seq.service
    for scheduler, seed in (("dpm", 11), ("euler_a", 12), ("dpm_2s_a", 13)):
        req = dict(base, scheduler=scheduler, seed=seed, num_samples=2)
        example, n, got_seed, key = svc._prepare(req)
        assert (n, got_seed, key) == (2, seed, (2, 2.0, scheduler))
        imgs = run_inference(
            svc.models, make_solver(svc.models.schedule, scheduler, 2), example,
            torch.Generator().manual_seed(seed), guidance_scale=2.0, latent_size=svc.latent_size)
        want = np.round(np.clip(imgs.numpy() / 2.0 + 0.5, 0.0, 1.0) * 255.0).astype(np.uint8)
        got = svc.submit(example, n, seed, key)["images"]
        assert got.dtype == np.uint8 and got.shape == (2, 32, 32, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, scheduler  # the device's uint8 packing
        resp = seq.post(req)
        assert np.array_equal(pixels(resp, 1), got[1].astype(np.int32))


def test_serve_pads_to_the_bucket_and_survives_a_burst(ws, base):
    """Three rows pad to bucket 4; then 12 mixed requests (seeds, 1-2
    samples, two step counts) from 4 threads all succeed, with every row
    accounted for."""
    svc = _service(ws[1], "--dynamic_batching", "--max_batch", "4", "--batch_wait_ms", "1500")
    served = _Served(svc, ThreadingHTTPServer)
    try:
        solo = _service(ws[1])
        trio = fire_all(served, [dict(base, seed=s, scheduler="euler_a") for s in (1, 2, 3)])
        assert [r["batch_rows"] for r in trio] == [3, 3, 3]
        stats = served.health()["stats"]
        assert (stats["batches"], stats["rows"], stats["padded_rows"]) == (1, 3, 1)
        for s, r in zip((1, 2, 3), trio):  # the padding rows change no real row
            ex, n, seed, key = solo._prepare(dict(base, seed=s, scheduler="euler_a"))
            want = solo.submit(ex, n, seed, key)["images"][0].astype(np.int32)
            assert np.abs(pixels(r) - want).max() <= SAME

        svc.args.batch_wait_ms = 30
        N = 12
        results, errors, lock = [], [], threading.Lock()

        def worker(w):
            for i in range(w, N, 4):
                body = dict(base, steps=2 if i % 3 else 3, seed=i, num_samples=1 + (i % 2))
                try:
                    r = served.post(body)
                    with lock:
                        results.append(r)
                except Exception as e:  # noqa: BLE001 - reported below
                    with lock:
                        errors.append((i, str(e)))

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:3]
        total = sum(len(r["images_b64"]) for r in results)
        assert len(results) == N and total == sum(1 + (i % 2) for i in range(N))
        stats = served.health()["stats"]
        assert stats["requests"] == N + 3 and stats["rows"] == total + 3
        assert stats["rejected"] == 0 and stats["thread_errors"] == 0
        assert svc.drain(timeout_s=30) is True
    finally:
        served.server.shutdown()


def test_a_failure_in_the_worker_thread_is_recorded(ws, base):
    svc = _service(ws[1], "--dynamic_batching", "--batch_wait_ms", "1")
    example, n, seed, key = svc._prepare(dict(base, seed=1))
    broken = dict(example, text_input_ids=example["text_input_ids"][:, :3])  # no room for the concept
    with pytest.raises(Exception):
        svc.submit(broken, n, seed, key)
    assert len(svc.thread_errors) == 1 and svc.health()["stats"]["thread_errors"] == 1
    assert svc.drain(timeout_s=30) is True
    assert svc.submit(example, n, seed, key)["images"].shape == (1, 32, 32, 3)  # and it serves on


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_dead_service_thread_fails_its_requests_instead_of_hanging(ws, base):
    svc = _service(ws[1], "--dynamic_batching", "--batch_wait_ms", "1")
    example, n, seed, key = svc._prepare(dict(base, seed=1))

    def die(group, rows):
        raise SystemExit("the worker is gone")  # no Exception: it ends the thread

    svc._dispatch_group = die
    with pytest.raises(SystemExit):
        svc.submit(example, n, seed, key)
    assert len(svc.thread_errors) == 1
    with pytest.raises(RuntimeError, match="a service thread died"):
        svc.submit(example, n, seed, key)


def test_warmup_runs_every_bucket_on_the_serving_thread(ws):
    svc = _service(ws[1], "--dynamic_batching", "--max_batch", "4", "--batch_wait_ms", "1")
    ran = []
    real = svc._dispatch_group
    svc._dispatch_group = lambda group, rows: (ran.append((threading.current_thread().name, rows)), real(group, rows))[1]
    svc.warmup(steps=1)
    assert ran == [("photoverse-batcher", 1), ("photoverse-batcher", 2), ("photoverse-batcher", 4)]
    assert list(svc._pipelines) == [(1, 6.0, "dpm")]  # one pipeline serves every bucket
    assert svc.health()["compiled_shapes"] == [[b, 1, 6.0, "dpm"] for b in (1, 2, 4)]
    assert svc.drain(30) and not svc.thread_errors
    solo = _service(ws[1])
    solo.warmup(steps=1, scheduler="euler_a")
    assert solo.health()["compiled_shapes"] == [[1, 1, 6.0, "euler_a"]]
