"""The port's CLIs under --sharding on two gloo ranks on the CPU, on the
tiny diffusers-layout directory of tests/test_cli_e2e.py: cli.generate in
each mode against its one-process run (the PNGs within one uint8 level),
and cli.serve under --sharding tensor and spatial answering two requests
over HTTP (one of them under an ancestral sampler) as a one-process
service does, then stopping every rank with exit code 0 when rank 0 gets
SIGTERM. The rank processes import no JAX; they run the CLIs' main(argv),
one job after another (tests/torch_tiny.py).
"""

import base64
import io
import json
import os
import re
import signal
import time
import urllib.request

import numpy as np
import pytest
from PIL import Image

from photoverse_tpu_torch.cli import generate as tgen
from photoverse_tpu_torch.cli.serve import PhotoVerseService, build_parser
from tests.test_cli_e2e import _make_checkpoint
from tests.torch_tiny import RANK_TIMEOUT_S, Processes, start_ranks

GEN_MODES = ("data", "tensor", "spatial")
SERVE_MODES = ("tensor", "spatial")
SAME_U8 = 1  # uint8 levels between a sharded run and its one-process run
GEN = ["--checkpoint_path", "", "--num_timesteps", "3", "--resolution", "32", "--encoder_layers_idx", "1", "2", "3",
       "4", "--seed", "7", "--num_of_samples", "3", "--guidance_scale", "2.0", "--cpu"]
SERVE = ["--resolution", "32", "--default_steps", "2", "--encoder_layers_idx", "1", "2", "3", "4", "--port", "0",
         "--cpu"]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_cli")
    root = _make_checkpoint(d)
    face = d / "face.jpg"
    Image.fromarray((np.random.RandomState(0).rand(64, 64, 3) * 255).astype(np.uint8)).save(face)
    body = {"image_b64": base64.b64encode(face.read_bytes()).decode(), "prompt": "the photo of a {}", "steps": 2,
            "guidance_scale": 2.0}
    return d, str(root), str(face), [dict(body, num_samples=2, seed=3), dict(body, seed=4, scheduler="euler_a")]


def _pngs(folder):
    return [np.asarray(Image.open(os.path.join(folder, f"generated_image{i}.png")), np.int32) for i in range(3)]


def _pixels(resp):
    return [np.asarray(Image.open(io.BytesIO(base64.b64decode(b))), np.int32) for b in resp["images_b64"]]


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


@pytest.fixture(scope="module")
def runs(ws):
    """One pair of ranks runs cli.generate in each mode, then cli.serve in
    each mode; each service answers the requests and rank 0 gets SIGTERM."""
    d, root, face, bodies = ws
    jobs = [dict(task="cli", cli="generate", argv=["--model_path", root, "--input_image_path", face,
                                                    "--results_dir", str(d / f"gen_{m}"), "--sharding", m] + GEN)
            for m in GEN_MODES]
    jobs += [dict(task="cli", cli="serve", argv=["--model_path", root, "--sharding", m] + SERVE) for m in SERVE_MODES]
    cmds, envs, _ = start_ranks(jobs, 2, d / "ranks")
    procs = Processes(cmds, d / "ranks", envs)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    served = {}
    try:
        for i, mode in enumerate(SERVE_MODES):
            while True:  # the service's i-th "listening" line on rank 0
                ports = re.findall(r"listening on http://127\.0\.0\.1:(\d+)", procs.output(0))
                if len(ports) > i:
                    break
                assert not procs.failed() and time.monotonic() < deadline, procs.output(0)[-3000:]
                time.sleep(0.1)
            served[mode] = [_post(ports[i], body) for body in bodies]
            os.kill(procs.procs[0].pid, signal.SIGTERM)
        outs = procs.wait(deadline)
    finally:
        procs.kill()
    return outs, served


@pytest.fixture(scope="module")
def one_process(ws):
    d, root, face, bodies = ws
    tgen.main(["--model_path", root, "--input_image_path", face, "--results_dir", str(d / "gen_one")] + GEN)
    svc = PhotoVerseService(build_parser().parse_args(["--model_path", root] + SERVE))
    return _pngs(d / "gen_one"), [svc.generate(body) for body in bodies]


@pytest.mark.parametrize("mode", GEN_MODES)
def test_generate_cli_sharded_matches_one_process(ws, runs, one_process, mode):
    outs, _ = runs
    assert "[parallel] backend gloo (--cpu); mesh" in outs[0]
    assert f"saved 3 image(s) to {ws[0] / f'gen_{mode}'}" in outs[0]  # rank 0 writes
    got, want = _pngs(ws[0] / f"gen_{mode}"), one_process[0]
    assert all(g.shape == w.shape == (32, 32, 3) for g, w in zip(got, want))
    assert max(np.abs(g - w).max() for g, w in zip(got, want)) <= SAME_U8


@pytest.mark.parametrize("mode", SERVE_MODES)
def test_serve_sharded_matches_one_process_and_stops_every_rank(ws, runs, one_process, mode):
    outs, served = runs
    for got, want in zip(served[mode], one_process[1]):
        a, b = _pixels(got), _pixels(want)
        assert got["seed"] == want["seed"] and len(a) == len(b) > 0
        assert max(np.abs(x - y).max() for x, y in zip(a, b)) <= SAME_U8
    # every rank returned from each service (runs asserted exit code 0)
    assert outs[1].count("[serve] rank 1: stopped by rank 0") == len(SERVE_MODES)
    assert outs[0].count("[serve] drained; exiting") == len(SERVE_MODES)
