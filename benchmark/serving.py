"""Serving cells: the program's PhotoVerseService built from the
configuration with the benchmark's weights, requests made from the seed,
the measured window that the traffic fills, and the check of the
served images against the plain reference.

Requests (all from the run's seed and the request's index): a face-like
224 px photo crop, CLIP-normalised; a 77-token prompt, BOS, word ids, the
placeholder at a position from 2 to 10, EOS, EOS padding; the empty
negative prompt; the request's own noise seed. The service is entered at
`submit()`, with no HTTP or image codec in the path.
"""

from __future__ import annotations

import argparse
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark import harness
from benchmark.models import latent_size, program_models, ref_cfg, DTYPES
from benchmark.weights import load_into, make_weights, named_params

__all__ = ["Request", "ServeCell", "face_crop", "prompt_ids", "reference_images"]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def face_crop(rng: np.random.Generator, size: int) -> np.ndarray:
    """A smooth random photo with a skin-toned ellipse and two dark eyes,
    (size, size, 3) uint8."""
    small = rng.integers(0, 256, (8, 8, 3)).astype(np.float32)
    big = np.kron(small, np.ones((size // 8 + 1, size // 8 + 1, 1), np.float32))[:size, :size]
    yy, xx = np.mgrid[0:size, 0:size] / size
    cy, cx = 0.5 + rng.uniform(-0.08, 0.08), 0.5 + rng.uniform(-0.08, 0.08)
    ry, rx = rng.uniform(0.28, 0.38), rng.uniform(0.2, 0.3)
    face = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    big[face] = np.array([224, 172, 140], np.float32) * rng.uniform(0.6, 1.1)
    for ex in (-0.4, 0.4):
        eye = ((yy - (cy - 0.3 * ry)) ** 2 + (xx - (cx + ex * rx)) ** 2) <= (0.12 * rx) ** 2
        big[eye] = 30.0
    big += rng.normal(0.0, 6.0, big.shape)
    return big.clip(0, 255).round().astype(np.uint8)


def prompt_ids(rng: np.random.Generator, length: int, bos: int, eos: int, placeholder=(2, 10)):
    """(ids (length,), placeholder index): BOS, word ids below BOS, EOS
    padding; the placeholder token (a word id) at a position drawn from
    `placeholder`."""
    p = int(rng.integers(placeholder[0], placeholder[1] + 1))
    n_words = int(rng.integers(p, p + 9))
    ids = np.full(length, eos, np.int32)
    ids[0] = bos
    ids[1:n_words + 1] = rng.integers(1, bos, n_words)
    return ids, p


class Request:
    __slots__ = ("index", "seed", "n", "key", "example", "due", "t_submit", "t_done", "service_s",
                 "batch_rows", "images", "error")

    def __init__(self, index, seed, n, key, example):
        self.index, self.seed, self.n, self.key, self.example = index, seed, n, key, example
        self.due = self.t_submit = self.t_done = None
        self.service_s = self.batch_rows = self.images = self.error = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.images is not None


class ServeCell:
    """The service of one serving cell and its requests."""

    def __init__(self, run):
        import torch

        self.run = run
        self.torch = torch
        cfg, wl = run.config, run.workload
        self.req_cfg = wl["requests"]
        self.server = wl["server"]
        dev = run.device
        with run.spans.span("build models"):
            self.models = program_models(cfg, dev, train=False, kernels=dev.type == "cuda")
            self.weights = make_weights(named_params(self.models), run.seed, dev, DTYPES[cfg["precision"]])
            load_into(self.models, self.weights)
        from photoverse_tpu_torch.cli.serve import PhotoVerseService

        pv = cfg["photoverse"]
        ns = argparse.Namespace(
            sharding="none", model_path="", resolution=cfg["resolution"], cpu=dev.type == "cpu",
            dynamic_batching=self.server["dynamic_batching"], max_batch=self.server["max_batch"],
            batch_wait_ms=self.server["batch_wait_ms"], max_queue=self.server["max_queue"],
            default_steps=self.req_cfg["steps"], native_tokenizer=False, fast=cfg["precision"] == "bf16",
            int8_conditioning=False, bf16_params=False, extra_num_tokens=pv["extra_num_tokens"],
            encoder_layers_idx=list(pv["image_encoder_layers_idx"]))
        with run.spans.span("build service"):
            self.service = PhotoVerseService(ns, models=(None, self.models))
        self.key = (self.req_cfg["steps"], float(self.req_cfg["guidance"]), self.req_cfg["scheduler"])

    # ------------------------------------------------------------------
    def make_request(self, index: int, n: Optional[int] = None, stream: int = 0) -> Request:
        """Request `index` of stream `stream` (0: the window's, 1: warm-up),
        a function of the run's seed and the index alone."""
        cfg, rc = self.run.config, self.req_cfg
        rng = np.random.default_rng([self.run.seed % (1 << 63), stream, index])
        n = n or rc["num_samples"]
        clip = cfg["vision_encoder"]["image_size"]
        t = cfg["text_encoder"]
        ids, pidx, crops = [], [], []
        for _ in range(n):
            crops.append((face_crop(rng, clip) / 255.0 - CLIP_MEAN) / CLIP_STD)
            i, p = prompt_ids(rng, t["max_position_embeddings"], t["bos_token_id"], t["eos_token_id"],
                              placeholder=tuple(rc["placeholder_positions"]))
            ids.append(i)
            pidx.append(p)
        neg = np.full((n, t["max_position_embeddings"]), t["eos_token_id"], np.int32)
        neg[:, 0] = t["bos_token_id"]
        example = {
            # batched with the rest but never uploaded: the pipeline starts from noise
            "pixel_values": np.zeros((n, 1, 1, 3), np.float32),
            "pixel_values_clip": np.stack(crops).astype(np.float32),
            "text_input_ids": np.stack(ids).astype(np.int32),
            "concept_placeholder_idx": np.asarray(pidx, np.int32),
            "negative_text_input_ids": neg,
        }
        seed = int(rng.integers(0, 1 << 62))
        return Request(index, seed, n, self.key, example)

    def submit(self, req: Request, keep: bool = True) -> None:
        """Serve `req` (blocking); records its times, result or error."""
        req.t_submit = time.perf_counter()
        try:
            with self.run.spans.span("submit"):
                out = self.service.submit(req.example, req.n, req.seed, req.key)
        except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
            req.error = repr(e)
            req.t_done = time.perf_counter()
            return
        req.t_done = time.perf_counter()
        req.service_s = out["latency_s"]
        req.batch_rows = out["batch_rows"]
        req.images = out["images"] if keep else None

    def warm_up(self) -> None:
        """The cell's own batch shapes, each served once before the window:
        the power-of-two buckets up to the largest batch the traffic forms,
        or the request's own rows without dynamic batching."""
        sizes = self.server.get("warm_batches") or [self.req_cfg["num_samples"]]
        for i, b in enumerate(sizes):
            req = self.make_request(i, n=b, stream=1)
            self.submit(req, keep=False)
            if req.error:
                raise RuntimeError(f"warm-up batch {b} failed: {req.error}")

    def stats(self) -> dict:
        return dict(self.service.health()["stats"])

    def free_program(self) -> None:
        """Release the program's device memory before the reference runs
        (the service's threads keep the objects alive, not their storage)."""
        torch = self.torch
        for p in self.models.parameters():
            p.data = torch.empty(0, device=p.device, dtype=p.dtype)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the check


def reference_images(weights, cfg: Dict, reqs: List[Request], device, numerics: str = "f32",
                     rows_per_call: int = 4) -> List[np.ndarray]:
    """The reference's uint8 images for `reqs` (each (n, H, W, 3)), from
    the same inputs and the same noise seeds, `rows_per_call` rows a call."""
    import torch

    from benchmark.reference import nets

    rc = ref_cfg(cfg)
    W = nets.Weights(weights, device)
    N = nets.Numerics(numerics)
    lat, ch = latent_size(cfg), cfg["unet"]["in_channels"]
    rows = []
    for r in reqs:
        g = torch.Generator(device=device).manual_seed(int(r.seed))
        noise = torch.randn((r.n, lat, lat, ch), generator=g, device=device)
        for j in range(r.n):
            rows.append((r, j, noise[j]))
    out = {id(r): [None] * r.n for r in reqs}
    steps, guidance, _ = reqs[0].key
    with torch.no_grad(), nets.strict_f32():
        for i in range(0, len(rows), rows_per_call):
            part = rows[i:i + rows_per_call]
            ex = {k: np.stack([r.example[k][j] for r, j, _ in part]) for k in
                  ("pixel_values_clip", "text_input_ids", "concept_placeholder_idx", "negative_text_input_ids")}
            noise = torch.stack([z for _, _, z in part])
            imgs = generate(W, N, rc, ex, noise, steps, guidance, device)
            for (r, j, _), im in zip(part, imgs):
                out[id(r)][j] = im
    return [np.stack(out[id(r)]) for r in reqs]


def generate(W, N, rc, ex, noise, steps: int, guidance: float, device) -> np.ndarray:
    """Identity-conditioned generation: conditioning, DPM-Solver++ with
    classifier-free guidance, VAE decode, uint8 packing."""
    import torch

    from benchmark.reference import nets

    px = torch.as_tensor(ex["pixel_values_clip"], device=device).float()
    ids = torch.as_tensor(ex["text_input_ids"], device=device).long()
    pidx = torch.as_tensor(ex["concept_placeholder_idx"], device=device).long().reshape(-1)
    feats = nets.vision_encoder(W, N, rc["vision"], px)
    concept = nets.adapter(W, N, "text_adapter", feats, [0])
    idc = nets.adapter(W, N, "image_adapter", feats, [0])
    text = nets.text_encoder(W, N, rc["text"], ids, concept, pidx)
    cfg_on = guidance != 1.0
    if cfg_on:
        idc0 = nets.adapter(W, N, "image_adapter", nets.vision_encoder(W, N, rc["vision"], torch.zeros_like(px)), [0])
        neg = torch.as_tensor(ex["negative_text_input_ids"], device=device).long()
        text = torch.cat([nets.text_encoder(W, N, rc["text"], neg), text])
        idc = torch.cat([idc0, idc])
    solver = nets.DPMSolver2M(steps)
    x = noise.float()
    m_prev = None
    B = x.shape[0]
    for i, t in enumerate(solver.timesteps):
        xin = torch.cat([x, x]) if cfg_on else x
        tt = torch.full((xin.shape[0],), int(t), device=device, dtype=torch.long)
        eps, _ = nets.unet(W, N, rc["unet"], xin, tt, text, idc)
        if cfg_on:
            eu, ec = eps[:B], eps[B:]
            eps = eu + guidance * (ec - eu)
        x, m_prev = solver.step(i, x, eps, m_prev)
    img = nets.vae_decode(W, N, rc["vae"], x / rc["vae"]["scaling_factor"]).clamp(-1.0, 1.0)
    return ((img / 2.0 + 0.5).clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).cpu().numpy()


def image_gaps(served: List[np.ndarray], ref: List[np.ndarray]) -> Dict[str, float]:
    """The worst request's mean and largest |served - reference| in uint8
    steps."""
    means, maxes = [], []
    for s, r in zip(served, ref):
        d = np.abs(s.astype(np.int32) - r.astype(np.int32))
        means.append(float(d.mean()))
        maxes.append(float(d.max()))
    return {"image_gap_mean": max(means), "image_gap_max": max(maxes)}


def check(run, cell: ServeCell, done: List[Request]) -> Dict[str, dict]:
    """Compare a sample of the window's served requests, drawn from the
    seed, with the reference; {name: {value, limit}}."""
    spec = run.workload["correct"]
    rng = np.random.default_rng([run.seed % (1 << 63), 7])
    pool = sorted(done, key=lambda r: r.index)
    k = min(spec["sample"], len(pool))
    pick = [pool[i] for i in sorted(rng.choice(len(pool), size=k, replace=False))] if k else []
    checks: Dict[str, dict] = {"requests_checked": {"value": k, "limit": spec["sample"], "rule": ">="}}
    if not pick:
        return checks
    ref = reference_images(cell.weights, run.config, pick, run.device)
    checks.update(judge(spec["limits"], [r.images for r in pick], ref))
    return checks


def judge(limits: Dict[str, float], served: List[np.ndarray], ref: List[np.ndarray]) -> Dict[str, dict]:
    """The image gaps of `served` against the reference's, each beside its
    limit."""
    return {name: {"value": v, "limit": limits[name], "rule": "<="} for name, v in image_gaps(served, ref).items()}


def passed(checks: Dict[str, dict]) -> bool:
    ok = True
    for c in checks.values():
        v, lim = c["value"], c["limit"]
        ok &= (v >= lim) if c.get("rule") == ">=" else (v <= lim and not math.isnan(v))
    return bool(ok)


def latencies(reqs: List[Request], start_key: str) -> List[float]:
    """Each request's seconds from `start_key` (due or t_submit) to its
    images delivered; a failed request reads inf."""
    return [(r.t_done - getattr(r, start_key)) if r.ok else math.inf for r in reqs]


def describe(reqs: List[Request]) -> str:
    done = [r for r in reqs if r.ok]
    rows = [r.batch_rows for r in done]
    return (f"{len(reqs)} requests, {len(done)} served, rows per batch "
            f"{statistics.mean(rows) if rows else 0:.2f}")


# ---------------------------------------------------------------------------
# one run


class Context:
    """What the per-layer readers read: the run, its window on the host
    clock, the window's requests, the service's counters over the window,
    the device trace (traced runs), the model FLOPs done in the window."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(run, drive) -> tuple:
    """Set up, warm up, measure the window that `drive` fills, then check.
    `drive` (a traffic module) has prepare(cell) -> state and go(cell, state, t0) -> the
    window's requests, each finished or failed. Returns (result, checks)."""
    from benchmark import flops
    from benchmark.trace import Profile

    torch = __import__("torch")
    cell = ServeCell(run)
    with run.spans.span("warm up"):
        cell.warm_up()
    state = drive.prepare(cell)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    stats0 = cell.stats()
    prof = Profile(run.device) if run.trace else None
    t0 = prof.start() if prof else time.perf_counter()
    setup_s = t0 - run.t_start
    reqs = drive.go(cell, state, t0)
    t1 = t0 + run.seconds
    trace = prof.stop() if prof else None
    stats1 = cell.stats()
    steps, guidance, _ = cell.key
    per_image = flops.generation(run.config, steps, guidance)
    images = harness.prorated([(r.t_submit, r.t_done, r.n) for r in reqs if r.ok], t0, t1)
    late = [r.t_submit - r.due for r in reqs if r.due is not None]
    print(f"[bench] window: {describe(reqs)}; generator late by median {statistics.median(late) if late else 0:.6f} s,"
          f" max {max(late) if late else 0:.6f} s", flush=True)
    ctx = Context(run=run, t0=t0, t1=t1, reqs=reqs, trace=trace, images=images, work_flops=images * per_image,
                  stats={k: stats1[k] - stats0.get(k, 0) for k in stats1 if isinstance(stats1[k], (int, float))},
                  spans=run.spans)
    e2e = {"setup_s": setup_s, "images_per_s": images / run.seconds}
    lat = latencies(reqs, "due")
    if lat:
        e2e["latency_p50_s"] = harness.percentile(lat, 0.5)
        e2e["latency_p90_s"] = harness.percentile(lat, 0.9)
    ctx.e2e = e2e
    print(f"[bench] end to end: {e2e}", flush=True)
    device = harness.device_info(run, trace, (t0, t1))
    metrics = harness.metric_values(run, ctx)
    result = {"correct": False, "attempted": len(reqs), "failed": sum(not r.ok for r in reqs),
              "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.top_ops(t0, t1), "idle_gaps": trace.idle_gaps(t0, t1, run.spans.label)}
    cell.free_program()
    with run.spans.span("check"):
        checks = check(run, cell, [r for r in reqs if r.ok])
    result["correct"] = passed(checks) and result["failed"] == 0 and bool(reqs)
    return result, checks
