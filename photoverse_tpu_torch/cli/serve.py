"""Serving CLI of the PyTorch port: keep the models warm behind HTTP.
Counterpart of photoverse_tpu/cli/serve.py on one GPU, or on several ranks
under --sharding; stdlib-only (http.server).

Two execution modes:

  default            one request at a time (single-threaded HTTP server);
                     the device runs each request's samples as one batch.
  --dynamic_batching concurrent requests with the same (steps, guidance,
                     scheduler) coalesce into one padded device batch
                     (threaded HTTP front end + one device-worker thread).
                     Per-request semantics are untouched: every request
                     draws its starting noise, and under an ancestral
                     sampler each of its rows' step noise, from its own seed
                     (engine/inference.py: draw_initial_noise,
                     make_row_generators), so its images do not depend on
                     the batch it landed in beyond the rounding of another
                     batch size's algorithms. Under --int8_conditioning
                     the CLIP encoders' activation scale is one per
                     tensor, so a coalesced request's conditioning depends
                     on its batch-mates and is not equal to its solo run
                     (as in the JAX package).

Device use, both modes:
  * images are denormalized and packed to uint8 on the device, with the
    arithmetic of utils.image (round(clip(x/2+0.5, 0, 1) * 255)), so the
    host fetch moves a quarter of the bytes;
  * under --dynamic_batching the worker thread enqueues a whole trajectory
    (kernel launches are asynchronous and the engine's step loop never
    waits for the device), enqueues the copy of the uint8 batch into pinned
    host memory behind it, records a CUDA event and hands the batch to a
    completion thread, which waits on the event and answers the requests.
    The worker meanwhile assembles and enqueues the next batch, so the
    device does not idle between batches. The copy is enqueued by the
    worker and not by the completion thread: both threads share the
    device's default stream, where a copy issued later would queue behind
    the next batch's kernels. A request's latency_s spans dispatch to
    fetch-complete, so it includes time queued behind the batch in flight.
  * torch.inference_mode and the current CUDA device are per thread: the
    worker enters them itself. The kernel wrappers and the kernels'
    tensor-map cache are entered by one thread at a time:
    the worker thread under --dynamic_batching, else whichever caller holds
    the sequential service's lock. The kernels are built in the
    constructor, before any thread starts.

  POST /generate
    {"image_b64": <base64 jpg/png> | "image_path": <server-local path>,
     "prompt": "a photo of a {}", "negative_prompt": null,
     "num_samples": 1, "steps": 25, "guidance_scale": 6.0, "seed": null,
     "scheduler": "dpm" | "ddim" | "euler" | "euler_a" | "unipc" |
                  "dpm_sde" | "heun" | "lms" | "dpm_2s_a" | "pndm"
                  (+ "_karras" for the Karras sigma grid, e.g.
                  "dpm_karras"; ddim and pndm have none; heun and dpm_2s_a
                  cost 2N-1 and pndm N+1 UNet evaluations for N steps)}
  -> {"images_b64": [<base64 png>, ...], "latency_s": ..., "seed": ...,
      "batch_rows": <rows in the device batch that served this request>}

  GET /healthz -> {"status": "ok", "compiled_shapes": [...], "stats": ...}

`PhotoVerseService(args, models=(tokenizer, models))` serves an already
built bundle instead of loading a directory, and `submit(example, n, seed,
key)` takes a prepared numpy example and returns uint8 arrays, so a caller
without files, Pillow or sockets can drive the same queue.

--sharding tensor|spatial serves every request on all the ranks of
`python -m torch.distributed.run --nproc_per_node N -m
photoverse_tpu_torch.cli.serve ...` (a 1 x N mesh, as the JAX server's):
rank 0 runs HTTP, the queue, the worker and the completion threads; before
each batch it enqueues, it broadcasts the batch to the other ranks (its
pipeline key, its example tensors, its noise and its row noise), which run
a follower loop (`follow`) and enter the same pipeline, so the sharded
collectives pair up. Shutdown (SIGTERM or SIGINT at rank 0, then the
drain) broadcasts a stop and every rank returns. The followers ignore
SIGTERM and SIGINT: the launcher signals every rank, and a follower ends on
rank 0's stop, after the batch in flight. At one rank the flag prints the
JAX server's warning and serves single-device.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import io
import itertools
import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

from photoverse_tpu_torch.utils import trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PhotoVerse serving (PyTorch port)")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--extra_num_tokens", type=int, default=4)
    p.add_argument("--encoder_layers_idx", nargs="+", type=int, default=[4, 8, 12, 16])
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--default_steps", type=int, default=25)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--dynamic_batching", action="store_true",
                   help="Coalesce concurrent requests with the same "
                        "(steps, guidance, scheduler) into one padded "
                        "device batch (power-of-two buckets up to "
                        "--max_batch). Per-request seeds are preserved: "
                        "each request's rows draw from its own seed")
    p.add_argument("--batch_wait_ms", type=int, default=25,
                   help="Dynamic batching: after the first request of a "
                        "batch arrives, wait this long for more "
                        "same-shaped requests before dispatching")
    p.add_argument("--max_queue", type=int, default=64,
                   help="Dynamic batching backpressure: reject requests "
                        "with HTTP 503 once this many are queued for the "
                        "device instead of growing latency without bound")
    p.add_argument("--fast", action="store_true",
                   help="bf16 + bf16 scores and norms, and on a GPU the "
                        "flash attention and fused block-tail kernels")
    p.add_argument("--bf16_params", action="store_true",
                   help="round the loaded weights through bfloat16 (under "
                        "--fast they are bf16 already)")
    p.add_argument("--int8_conditioning", action="store_true",
                   help="W8A8 dynamic-int8 projections and MLPs in the frozen "
                        "CLIP encoders (inference-only); the activation scale "
                        "is per tensor, so coalesced requests are not equal "
                        "to their solo runs")
    p.add_argument("--warmup", action="store_true",
                   help="run the default configuration at startup")
    p.add_argument("--sharding", type=str, default="none",
                   choices=["none", "spatial", "tensor"],
                   help="Serve every request across all the ranks of "
                        "`python -m torch.distributed.run`: spatial = latent "
                        "rows split (halo-exchanged convs, gathered K/V); "
                        "tensor = Megatron heads/FFN UNet sharding. With "
                        "--fast the flash kernel runs on each rank's share; "
                        "the fused block tail stays off")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (the default is the GPU)")
    p.add_argument("--native_tokenizer", action="store_true",
                   help="C++ BPE tokenizer (native/tokenizer.cc, built with "
                        "g++ at start-up); a failed build stops the server, "
                        "there is no fallback to the Python tokenizer")
    return p


class ServiceOverloaded(RuntimeError):
    """Raised when the dynamic-batching queue is at --max_queue; the HTTP
    handler maps it to 503 so load balancers can shed or retry elsewhere."""


class _Pending:
    """One enqueued request awaiting the device-worker thread."""

    __slots__ = ("example", "n", "seed", "key", "event", "images",
                 "error", "latency_s", "batch_rows", "enqueued", "request", "queued")

    def __init__(self, example, n, seed, key, request):
        self.example = example
        self.n = n
        self.seed = seed
        self.key = key  # (steps, guidance, scheduler)
        self.event = threading.Event()
        self.images = None
        self.error = None
        self.latency_s = 0.0
        self.batch_rows = n
        self.request = request  # the service's request number
        self.queued = trace.span("queued", request=request)  # ends when the worker takes it
        self.enqueued = time.perf_counter()


def _bucket(rows: int) -> int:
    """The power-of-two batch that `rows` rows are padded to."""
    bucket = 1
    while bucket < rows:
        bucket *= 2
    return bucket


class _Pipeline:
    """One (steps, guidance, scheduler) configuration, for any batch: the
    solver with its step tables on the device, and the call that enqueues a
    whole generation and packs the images to uint8 on the device."""

    def __init__(self, service, solver, guidance, key):
        self.service = service
        self.solver = solver
        self.guidance = guidance
        self.key = key  # (steps, guidance, scheduler)
        solver.step_inputs(service.device)  # uploaded once, cached in the solver

    def __call__(self, example, noise, ancestral_noise):
        import torch

        from photoverse_tpu_torch.engine.inference import run_inference

        s = self.service
        with torch.inference_mode():
            img = run_inference(
                s.models, self.solver, example,
                guidance_scale=self.guidance, token_index=0, latent_size=s.latent_size,
                initial_noise=noise, ancestral_noise=ancestral_noise, spatial=s.spatial,
            )
            u = (img.float() / 2.0 + 0.5).clamp(0.0, 1.0)
            return (u * 255.0).round().to(torch.uint8)


class PhotoVerseService:
    """Holds the model bundle and a cache of pipelines keyed by (steps,
    guidance, scheduler); nothing is compiled per batch size, so the
    (batch, steps, guidance, scheduler) shapes it has run are only kept for
    /healthz."""

    _EXAMPLE_KEYS = (
        "pixel_values", "pixel_values_clip", "text_input_ids",
        "concept_placeholder_idx", "negative_text_input_ids",
    )
    # what the pipeline reads on the device: it starts from pure noise, so
    # `pixel_values` is batched with the rest but never uploaded
    _DEVICE_KEYS = _EXAMPLE_KEYS[1:]
    # the dtypes `_prepare` gives them, which the followers receive
    _INT_KEYS = ("text_input_ids", "concept_placeholder_idx", "negative_text_input_ids")

    def __init__(self, args, models=None):
        import torch

        from photoverse_tpu_torch.cli.generate import pick_device, sharding_plan

        self.args = args
        mode, _, mp = sharding_plan(args.sharding, args.model_path, args.resolution, serving=True)
        self.mesh = self.spatial = None
        if mode != "none":
            from photoverse_tpu_torch.parallel.mesh import open_mesh

            if models is not None:
                raise ValueError("--sharding builds each rank's models itself: pass no models=")
            self.mesh = open_mesh(1, mp, cpu=args.cpu)
            self.device = self.mesh.device
        else:
            self.device = torch.device(pick_device(args.cpu))
        on_card = self.device.type == "cuda"
        if on_card:  # with its index, as torch.cuda.set_device wants it
            self.device = torch.device("cuda", torch.cuda.current_device())
        # one batch's broadcast and run, or the stop, at a time (rank 0)
        self._lead_lock = threading.Lock()
        if models is None:
            from photoverse_tpu_torch.models.assembly import cast_params, load_models
            from photoverse_tpu_torch.parallel import shard_models

            # under tensor / spatial the fused tail and the VAE's stream
            # kernel stay off and the UNet's flash kernel comes back through
            # the sharded wrapper: the JAX server's configuration
            kernels = args.fast and on_card
            model_sharded = mode != "none"
            self.tokenizer, self.models, _ = load_models(
                args.model_path,
                extra_num_tokens=args.extra_num_tokens,
                photoverse_path=args.checkpoint_path or None,
                image_encoder_layers_idx=tuple(args.encoder_layers_idx),
                dtype=torch.bfloat16 if args.fast else torch.float32,
                use_flash_attention=kernels and not model_sharded,
                fast_attention_scores=args.fast,
                fast_norms=args.fast,
                fused_blocks=kernels and not model_sharded,
                int8_conditioning=args.int8_conditioning,
                device=self.device,
            )
            if args.bf16_params:
                cast_params(self.models, torch.bfloat16)
            if self.mesh is not None:
                self.spatial = shard_models(self.models, self.mesh, mode, flash=kernels)
        else:
            self.tokenizer, self.models = models
            if self.models.device.type != self.device.type:
                raise ValueError(f"the models are on {self.models.device}, the service on {self.device}")
        if args.native_tokenizer:
            # no fallback: a failed build raises NativeBuildError
            from photoverse_tpu_torch.data.native_tokenizer import NativeCLIPTokenizer

            self.tokenizer = NativeCLIPTokenizer.from_pretrained(args.model_path, subfolder="tokenizer")
        if on_card:
            # the first-use build must not race between threads
            from photoverse_tpu_torch.ops import _build

            _build.load_library()
        self.latent_size = args.resolution // self.models.vae_scale
        # an SDXL bundle's rows also carry their six time ids (its added
        # conditioning), batched and padded with the rest
        extra = ("add_time_ids",) if self.models.sdxl else ()
        self._example_keys = self._EXAMPLE_KEYS + extra
        self._device_keys = self._DEVICE_KEYS + extra
        self.clip_size = self.models.vision_encoder.config.image_size
        self._pipelines = {}
        self._shapes = []  # (batch, steps, guidance, scheduler) run so far, in order
        # guards _pipelines, _shapes and _stats against handler / worker races
        # (handler threads tokenize without a lock: the Python BPE's merge
        # cache is idempotent and its updates are atomic under the GIL, the
        # native tokenizer's C++ cache is guarded by a mutex)
        self._state_lock = threading.Lock()
        # the sequential service runs one submit() at a time, whatever
        # threads call it (under dynamic batching the worker is the only
        # thread that enqueues device work)
        self._sequential_lock = threading.Lock()
        # exceptions of the worker and completion threads, kept beside the
        # `error` each waiting request gets, so a caller can fail a run
        self.thread_errors = []

        # dynamic batching: handler threads enqueue, one worker thread owns
        # device dispatch, one completion thread waits for results
        self._queue = None
        self._qcond = threading.Condition()
        self._active = 0  # groups popped from the queue, not yet delivered
        self._dead = None  # what killed a service thread, if one died
        self._inflight = deque()  # dispatched groups awaiting their event
        self._inflight_cond = threading.Condition()
        # 1 queued in-flight entry + 1 at the completion thread + 1 being
        # assembled at the worker: up to 3 batches enqueued ahead of the
        # oldest unfinished fetch, enough to hide fetch and assembly without
        # letting the latency queued behind the pipeline grow without bound
        self._max_inflight = 1
        self._stats = {"requests": 0, "batches": 0, "rows": 0,
                       "padded_rows": 0, "rejected": 0}
        # numbers of the requests and batches in the spans (utils/trace.py)
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()
        if args.dynamic_batching:
            self._queue = deque()
            threading.Thread(
                target=self._guarded, args=(self._worker_loop,),
                name="photoverse-batcher", daemon=True,
            ).start()
            threading.Thread(
                target=self._guarded, args=(self._completion_loop,),
                name="photoverse-fetcher", daemon=True,
            ).start()

    def _guarded(self, loop):
        """Run a service thread. Whatever kills it is recorded, and every
        request that waits, or comes later, gets the error instead of
        waiting for a thread that is gone."""
        import torch

        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            loop()
        except BaseException as e:  # noqa: BLE001 - recorded, then the thread ends
            self.thread_errors.append(e)
            with self._qcond:
                self._dead = e
                waiting = list(self._queue)
                self._queue.clear()
                self._qcond.notify_all()
            with self._inflight_cond:
                waiting += [g for entry in self._inflight for g in entry[0]]
                self._inflight.clear()
            for g in waiting:
                g.error = e
                g.event.set()
            raise

    # ------------------------------------------------------------------
    # pipelines

    def _pipeline(self, batch: int, steps: int, guidance: float, scheduler: str = "dpm") -> _Pipeline:
        from photoverse_tpu_torch.core.schedulers import make_solver

        key = (steps, guidance, scheduler)
        with self._state_lock:
            pipe = self._pipelines.get(key)
        if pipe is None:
            pipe = _Pipeline(self, make_solver(self.models.schedule, scheduler, steps), guidance, key)
        with self._state_lock:
            pipe = self._pipelines.setdefault(key, pipe)
            if (batch, *key) not in self._shapes:
                self._shapes.append((batch, *key))
        return pipe

    def _make_noise(self, seed: int, n: int):
        """The starting noise the one-shot path draws for this seed:
        run_inference(generator=Generator().manual_seed(seed)) at batch n."""
        import torch

        from photoverse_tpu_torch.engine.inference import draw_initial_noise

        g = torch.Generator(device=self.device).manual_seed(int(seed))
        in_ch = self.models.unet.config.in_channels
        return draw_initial_noise(g, (n, self.latent_size, self.latent_size, in_ch), self.device)

    def _make_row_noise(self, seed: int, n: int, solver):
        """(N, n, l, l, C) step noise of a request's rows under an ancestral
        solver (None otherwise), from the row generators run_inference would
        derive for this seed: equal to the one-shot path and independent of
        the batch the rows land in."""
        from photoverse_tpu_torch.engine.inference import draw_ancestral_noise, make_row_generators

        if not solver.is_ancestral:
            return None
        in_ch = self.models.unet.config.in_channels
        return draw_ancestral_noise(
            make_row_generators(int(seed), n, self.device), solver.num_steps,
            (self.latent_size, self.latent_size, in_ch), self.device)

    def warmup(self, steps=None, guidance: float = 6.0, scheduler: str = "dpm"):
        """Run the serving pipelines once before traffic: bucket 1 always,
        plus every power-of-two bucket up to --max_batch under dynamic
        batching. Each batch size picks its own library algorithms and
        grows the allocator's pools, and cuDNN keeps its execution plans
        per thread, so under dynamic batching the dummy requests go through
        the queue and run on the worker thread that will serve (they count
        in the stats). Dummy inputs have the keys, shapes and dtypes
        `_prepare` produces."""
        import numpy as np

        steps = steps or self.args.default_steps
        buckets = [1]
        if self._queue is not None:
            b = 2
            while b <= self.args.max_batch:
                buckets.append(b)
                b *= 2
        res = self.args.resolution
        for b in buckets:
            example = {
                "pixel_values": np.zeros((b, res, res, 3), np.float32),
                "pixel_values_clip": np.zeros((b, self.clip_size, self.clip_size, 3), np.float32),
                "text_input_ids": np.asarray(self.tokenizer(["a photo of a *"] * b), np.int32),
                "concept_placeholder_idx": np.zeros((b,), np.int32),
                "negative_text_input_ids": np.asarray(self.tokenizer([""] * b), np.int32),
            }
            print(f"[serve] warmup: bucket {b} ({steps} steps, guidance {guidance})", flush=True)
            self.submit(example, b, 0, (steps, guidance, scheduler))

    def _upload(self, example: dict) -> dict:
        """numpy example -> tensors on the device, through pinned memory
        and without waiting for the device on a GPU."""
        import torch

        out = {}
        for k in self._device_keys:
            t = torch.from_numpy(example[k])
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # ------------------------------------------------------------------
    # request preparation (handler thread; CPU-only work)

    def _prepare(self, req: dict):
        import numpy as np

        from photoverse_tpu_torch.cli.generate import preprocess_image_for_inference
        from photoverse_tpu_torch.core.schedulers import SCHEDULER_NAMES

        n = min(int(req.get("num_samples", 1)), self.args.max_batch)
        steps = int(req.get("steps", self.args.default_steps))
        guidance = float(req.get("guidance_scale", 6.0))
        scheduler = str(req.get("scheduler", "dpm"))
        if scheduler not in SCHEDULER_NAMES:
            raise ValueError(
                f"unknown scheduler: {scheduler} (expected one of {list(SCHEDULER_NAMES)})")
        prompt = req.get("prompt", "a photo of a {}")
        if "{}" not in prompt:
            prompt = prompt + " {}" if prompt else "a photo of a {}"

        if "image_b64" in req:
            from PIL import Image

            # decoded in memory; preprocess takes a PIL image directly
            path = Image.open(io.BytesIO(base64.b64decode(req["image_b64"])))
            path.load()
        else:
            path = req["image_path"]

        example = preprocess_image_for_inference(
            path, self.tokenizer, template=prompt,
            negative_prompt=req.get("negative_prompt"),
            num_of_samples=n,
            size=self.args.resolution, clip_size=self.clip_size,
        )
        if example.get("negative_text_input_ids") is None:
            # per-row negatives make mixed batches coalescible: rows
            # without an explicit negative use the empty prompt
            example["negative_text_input_ids"] = np.asarray(self.tokenizer([""] * n))

        ex = {}
        for k in self._EXAMPLE_KEYS:
            v = np.asarray(example[k])
            ex[k] = v.astype(np.int32) if np.issubdtype(v.dtype, np.integer) else v.astype(np.float32)
        ex["concept_placeholder_idx"] = ex["concept_placeholder_idx"].reshape(n)

        seed = req.get("seed")
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        return ex, n, int(seed), (steps, guidance, scheduler)

    # ------------------------------------------------------------------
    # dynamic batching (one device-worker thread)

    def _worker_loop(self):
        while True:
            with self._qcond:
                while not self._queue:
                    self._qcond.wait()
                first = self._queue.popleft()
                self._active += 1
            coalesce = trace.span("coalesce")
            first.queued.end()
            group = [first]
            rows = first.n
            # the wait window opens when the request arrived, not when the
            # worker got to it: a request that already queued through a
            # previous batch's device run dispatches at once
            deadline = first.enqueued + self.args.batch_wait_ms / 1000.0
            while rows < self.args.max_batch:
                with self._qcond:
                    take = None
                    for item in self._queue:
                        if item.key == first.key and rows + item.n <= self.args.max_batch:
                            take = item
                            break
                    if take is not None:
                        self._queue.remove(take)
                    else:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._qcond.wait(timeout=remaining)
                        continue
                take.queued.end()
                group.append(take)
                rows += take.n
            ids = {"batch": next(self._batch_ids), "rows": rows, "bucket": _bucket(rows),
                   "requests": [g.request for g in group]}
            coalesce.end(**ids)
            try:
                with trace.span("dispatch", **ids):
                    entry = self._dispatch_group(group, rows)
            except BaseException as e:  # noqa: BLE001 - deliver the failure to every waiter
                for g in group:
                    g.error = e
                    g.event.set()
                with self._qcond:
                    self._active -= 1
                    self._qcond.notify_all()
                if not isinstance(e, Exception):
                    raise  # the thread ends; _guarded records it
                self.thread_errors.append(e)
                continue
            # hand the batch in flight to the completion thread and go on
            # to coalesce the next one; bounded, so a slow fetch applies
            # backpressure instead of queueing device work without bound
            with trace.span("inflight_wait", **ids), self._inflight_cond:
                while len(self._inflight) > self._max_inflight:
                    self._inflight_cond.wait()
                self._inflight.append((*entry, ids))
                self._inflight_cond.notify_all()

    def _completion_loop(self):
        """Wait for each dispatched batch's event and answer its requests.
        While this thread waits on batch N, the worker has already enqueued
        batch N+1, so the device does not idle between batches."""
        while True:
            with self._inflight_cond:
                while not self._inflight:
                    self._inflight_cond.wait()
                group, rows, bucket, host_images, event, t0, ids = self._inflight.popleft()
                self._inflight_cond.notify_all()
            try:
                with trace.span("device_wait", **ids):
                    if event is not None:
                        event.synchronize()  # an asynchronous device failure surfaces here
                    images = host_images.numpy()
            except BaseException as e:  # noqa: BLE001 - delivered; only an Exception is survived
                for g in group:
                    g.error = e
                    g.event.set()
                if not isinstance(e, Exception):
                    raise
                self.thread_errors.append(e)
            else:
                latency = time.perf_counter() - t0
                with trace.span("deliver", **ids):
                    with self._state_lock:
                        self._stats["batches"] += 1
                        self._stats["rows"] += rows
                        self._stats["padded_rows"] += bucket - rows
                    off = 0
                    for g in group:
                        g.images = images[off:off + g.n]
                        g.latency_s = latency
                        g.batch_rows = rows
                        off += g.n
                        g.event.set()
            finally:
                with self._qcond:
                    self._active -= 1
                    self._qcond.notify_all()

    def drain(self, timeout_s: float = 600.0) -> bool:
        """Graceful-shutdown helper: wait until every queued or in-flight
        dynamic-batching request has been served (or the timeout). Call
        after the HTTP server stops accepting. True when fully drained."""
        if self._queue is None:
            return True
        deadline = time.monotonic() + timeout_s
        with self._qcond:
            while self._queue or self._active:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._qcond.wait(timeout=min(remaining, 1.0))
        return True

    def _run(self, example: dict, noise, row_noise, pipe: _Pipeline):
        """Enqueue one batch and the copy of its uint8 images to the host;
        returns (host tensor, event or None). Nothing here waits for the
        device: on a GPU the host tensor is pinned and holds the images
        once the event has passed (under --sharding the collectives wait,
        and the batch goes to the followers first)."""
        import torch

        dev_example = self._upload(example)
        if self.mesh is None:
            images = pipe(dev_example, noise, row_noise)
        else:
            with self._lead_lock:
                self._lead(pipe, dev_example, noise, row_noise)
                images = pipe(dev_example, noise, row_noise)
        if self.device.type != "cuda":
            return images, None
        host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
        host.copy_(images, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _dispatch_group(self, group, rows: int):
        """Assemble, upload and enqueue one coalesced batch, padded to its
        power-of-two bucket by repeating the last row (its noise too);
        returns the in-flight entry for the completion thread."""
        import numpy as np
        import torch

        bucket = _bucket(rows)
        steps, guidance, scheduler = group[0].key
        pipe = self._pipeline(bucket, steps, guidance, scheduler)

        def padded(parts, dim, cat, rep):
            x = cat(parts, dim)
            return x if bucket == rows else cat([x, rep(x, bucket - rows)], dim)

        batch = {
            k: padded([g.example[k] for g in group], 0, np.concatenate,
                      lambda x, r: np.repeat(x[-1:], r, axis=0))
            for k in self._example_keys
        }
        noise = padded([self._make_noise(g.seed, g.n) for g in group], 0, torch.cat,
                       lambda x, r: x[-1:].expand(r, *x.shape[1:]))
        row_noise = None
        if pipe.solver.is_ancestral:
            row_noise = padded([self._make_row_noise(g.seed, g.n, pipe.solver) for g in group], 1, torch.cat,
                               lambda x, r: x[:, -1:].expand(x.shape[0], r, *x.shape[2:]))
        t0 = time.perf_counter()
        host, event = self._run(batch, noise, row_noise, pipe)
        return (group, rows, bucket, host, event, t0)

    # ------------------------------------------------------------------
    # --sharding: rank 0 leads, the other ranks follow

    def _header(self, *values):
        import torch

        return torch.tensor(values or (0,) * 6, dtype=torch.float64)

    def _lead(self, pipe: _Pipeline, example: dict, noise, row_noise) -> None:
        """Send one batch to the followers: its header (go, batch, steps,
        guidance, scheduler index, token length) over the control group,
        then its example tensors, noise and row noise."""
        import torch

        from photoverse_tpu_torch.core.schedulers import SCHEDULER_NAMES

        steps, guidance, scheduler = pipe.key
        ids = example["text_input_ids"]
        self.mesh.control_comm.broadcast(self._header(
            1, noise.shape[0], steps, guidance, SCHEDULER_NAMES.index(scheduler), ids.shape[1]))
        world = self.mesh.world_comm
        for k in self._DEVICE_KEYS:
            world.broadcast(example[k].to(torch.int32 if k in self._INT_KEYS else torch.float32))
        world.broadcast(noise.float())
        if row_noise is not None:
            world.broadcast(row_noise.float())

    def follow(self) -> None:
        """A follower rank's loop: receive each batch rank 0 enqueues and
        run the same pipeline on it (the images stay on rank 0); return on
        rank 0's stop."""
        import torch

        from photoverse_tpu_torch.core.schedulers import SCHEDULER_NAMES

        world = self.mesh.world_comm
        latent, in_ch = self.latent_size, self.models.unet.config.in_channels

        def recv(shape, dtype):
            return world.broadcast(torch.empty(shape, dtype=dtype, device=self.device))

        while True:
            head = [float(x) for x in self.mesh.control_comm.broadcast(self._header())]
            if head[0] == 0:
                return
            b, steps, sched, length = int(head[1]), int(head[2]), int(head[4]), int(head[5])
            pipe = self._pipeline(b, steps, head[3], SCHEDULER_NAMES[sched])
            shapes = {"pixel_values_clip": (b, self.clip_size, self.clip_size, 3),
                      "text_input_ids": (b, length), "concept_placeholder_idx": (b,),
                      "negative_text_input_ids": (b, length)}
            example = {k: recv(shapes[k], torch.int32 if k in self._INT_KEYS else torch.float32)
                       for k in self._DEVICE_KEYS}
            noise = recv((b, latent, latent, in_ch), torch.float32)
            row_noise = None
            if pipe.solver.is_ancestral:
                row_noise = recv((pipe.solver.num_steps, b, latent, latent, in_ch), torch.float32)
            pipe(example, noise, row_noise)

    def stop_followers(self) -> None:
        """Rank 0: end the followers' loops (after the batch in flight)."""
        with self._lead_lock:
            self.mesh.control_comm.broadcast(self._header())

    # ------------------------------------------------------------------

    def _overloaded(self) -> bool:
        return len(self._queue) >= self.args.max_queue

    def _reject(self):
        with self._state_lock:
            self._stats["rejected"] += 1
        raise ServiceOverloaded(f"queue full ({self.args.max_queue} pending)")

    def submit(self, example: dict, n: int, seed: int, key) -> dict:
        """Serve one prepared request: `example` as `_prepare` returns it
        (numpy, the five keys, n rows), `key` = (steps, guidance,
        scheduler). Enqueues it under dynamic batching, else runs it at
        once. Returns {"images": uint8 (n, H, W, 3), "latency_s",
        "batch_rows"}; raises ServiceOverloaded when the queue is full.
        An SDXL service's example may carry `add_time_ids` (n, 6); rows
        without get the served resolution's, uncropped."""
        if self.models.sdxl and "add_time_ids" not in example:
            from photoverse_tpu_torch.engine.inference import sdxl_time_ids

            example = dict(example, add_time_ids=sdxl_time_ids(n, self.args.resolution, "cpu").numpy())
        with self._state_lock:
            self._stats["requests"] += 1
        request = next(self._request_ids)
        with trace.span("request", request=request):
            if self._queue is not None:
                with self._qcond:
                    if self._dead is not None:
                        raise RuntimeError(f"a service thread died: {self._dead!r}")
                    if self._overloaded():
                        self._reject()
                    pending = _Pending(example, n, seed, key, request)
                    self._queue.append(pending)
                    self._qcond.notify_all()
                pending.event.wait()
                if pending.error is not None:
                    raise pending.error
                return {"images": pending.images, "latency_s": pending.latency_s,
                        "batch_rows": pending.batch_rows}
            steps, guidance, scheduler = key
            pipe = self._pipeline(n, steps, guidance, scheduler)
            with self._sequential_lock:
                t0 = time.perf_counter()
                with trace.span("dispatch", request=request, rows=n, bucket=n):
                    host, event = self._run(example, self._make_noise(seed, n),
                                            self._make_row_noise(seed, n, pipe.solver), pipe)
                with trace.span("device_wait", request=request):
                    if event is not None:
                        event.synchronize()
                    images = host.numpy()
                latency = time.perf_counter() - t0
            return {"images": images, "latency_s": latency, "batch_rows": n}

    def generate(self, req: dict) -> dict:
        from PIL import Image

        if self._queue is not None:
            # shed load before paying image decode and preprocessing for a
            # request that would be rejected anyway (a racy check; the
            # authoritative one guards the enqueue in submit)
            with self._qcond:
                overloaded = self._overloaded()
            if overloaded:
                with self._state_lock:
                    self._stats["requests"] += 1
                self._reject()
        example, n, seed, key = self._prepare(req)
        res = self.submit(example, n, seed, key)
        out = []
        for img in res["images"]:  # uint8 already, packed on the device
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            out.append(base64.b64encode(buf.getvalue()).decode())
        return {
            "images_b64": out,
            "latency_s": round(res["latency_s"], 3),
            "seed": seed,
            "batch_rows": res["batch_rows"],
        }

    def health(self) -> dict:
        with self._state_lock:
            stats = dict(self._stats)
            shapes = [list(k) for k in self._shapes]
        if stats["batches"]:
            stats["mean_rows_per_batch"] = round(stats["rows"] / stats["batches"], 3)
        stats["thread_errors"] = len(self.thread_errors)
        return {
            "status": "ok",
            "compiled_shapes": shapes,
            "resolution": self.args.resolution,
            "dynamic_batching": self._queue is not None,
            "stats": stats,
        }


def make_handler(service: PhotoVerseService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, service.health())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                self._reply(200, service.generate(req))
            except ServiceOverloaded as e:  # backpressure: shed load
                self._reply(503, {"error": str(e)})
            except Exception as e:  # surface errors to the client
                self._reply(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            print(f"[serve] {fmt % args}")

    return Handler


def main(argv=None):
    args = build_parser().parse_args(argv)
    service = PhotoVerseService(args)
    mesh = service.mesh
    try:
        if mesh is not None and mesh.rank != 0:
            import signal

            # the launcher signals every rank; rank 0's stop ends this loop
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            signal.signal(signal.SIGINT, signal.SIG_IGN)
            service.follow()
            print(f"[serve] rank {mesh.rank}: stopped by rank 0", flush=True)
            return
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                stack.callback(service.stop_followers)
            _serve(args, service)
    finally:
        if mesh is not None:
            from photoverse_tpu_torch.parallel.mesh import close_mesh

            close_mesh(mesh)


def _serve(args, service):
    if args.warmup:
        service.warmup()
    # dynamic batching needs concurrent handlers so requests can overlap in
    # the queue; the device itself stays single-consumer (the worker thread)
    server_cls = ThreadingHTTPServer if args.dynamic_batching else HTTPServer
    server = server_cls((args.host, args.port), make_handler(service))

    # graceful shutdown: SIGTERM/SIGINT stop the accept loop, then queued and
    # in-flight requests drain before exit (serve_forever cannot be shut
    # down from its own thread, hence the helper thread)
    import signal

    def _term(signum, frame):
        print(f"[serve] signal {signum}: stopping accept loop, draining")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    mode = "dynamic batching" if args.dynamic_batching else "sequential"
    ranks = "" if service.mesh is None else f", --sharding {args.sharding} over {service.mesh.world} ranks"
    host, port = server.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} ({mode}, {service.device}{ranks})", flush=True)
    server.serve_forever()
    server.server_close()
    drained = service.drain()
    print(f"[serve] {'drained' if drained else 'DRAIN TIMEOUT'}; exiting", flush=True)


if __name__ == "__main__":
    main()
