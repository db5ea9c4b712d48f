"""Serving cells of an SDXL configuration: the program's PhotoVerseService
built from an SDXL bundle (`build_models` with the second text encoder)
and the benchmark's weights, requests made from the seed, the measured
window that the traffic fills, the check of the served images against
the plain SDXL reference (benchmark/reference/sdxl_nets.py), and the
control of that check.

Requests are serving.py's (a face-like 224 px crop, a 77-token prompt with
the placeholder at 2..10, the request's own noise seed), the one id
sequence read by both text encoders, plus each row's six SDXL time ids
(the configuration's resolution, no crop). The service is entered at
`submit()`.

The control (`python3 benchmark/serving_sdxl.py --workload <cell> --seeds
<n> <n> <n>`, on the card) puts the reference computed with fp8 operands in
the program's place on the cell's first `sample` requests of each seed and
judges it against the f32 reference by the cell's own limits; it prints
one JSON line per seed with `correct`, the checks and the f32 reference's
seconds per request.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

if __name__ == "__main__":  # run as a script: the benchmark is the package `benchmark`
    HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness, serving  # noqa: E402
from benchmark.models import DTYPES  # noqa: E402
from benchmark.serving import CLIP_MEAN, CLIP_STD, Context, Request, face_crop, judge, latencies, passed, \
    prompt_ids  # noqa: E402
from benchmark.weights import load_into, make_weights, named_params  # noqa: E402

__all__ = ["SDXLServeCell", "program_models", "ref_cfg", "reference_images", "check", "run_cell", "control"]


def _port_configs(cfg: Dict) -> dict:
    """build_models' configuration arguments for an SDXL configuration file."""
    from photoverse_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
    from photoverse_tpu_torch.models.unet import UNetConfig
    from photoverse_tpu_torch.models.vae import VAEConfig

    u, v, i, pv, fl = (cfg[k] for k in ("unet", "vae", "vision_encoder", "photoverse", "flags"))
    heads = tuple(u["attention_head_dim"])
    unet = UNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]), layers_per_block=u["layers_per_block"],
        cross_attention_dim=u["cross_attention_dim"], num_heads=heads[-1], norm_num_groups=u["norm_num_groups"],
        lora_rank=pv["lora_rank"], lora_alpha=pv["lora_alpha"], use_flash_attention=fl["use_flash_attention"],
        fast_attention_scores=fl["fast_attention_scores"], fast_norms=fl["fast_norms"],
        fused_blocks=fl["fused_blocks"], level_heads=heads,
        transformer_layers_per_block=tuple(u["transformer_layers_per_block"]),
        attention_levels=tuple("CrossAttn" in t for t in u["down_block_types"]),
        use_linear_projection=u["use_linear_projection"], addition_embed_type=u["addition_embed_type"],
        addition_time_embed_dim=u["addition_time_embed_dim"],
        addition_text_embed_dim=u["projection_class_embeddings_input_dim"] - 6 * u["addition_time_embed_dim"])
    vae = VAEConfig(
        in_channels=v["in_channels"], out_channels=v["out_channels"], latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]), layers_per_block=v["layers_per_block"],
        norm_num_groups=v["norm_num_groups"], scaling_factor=v["scaling_factor"],
        use_flash_attention=fl["use_flash_attention"], fast_norms=fl["fast_norms"])

    def text(t):
        return CLIPTextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"], num_layers=t["num_hidden_layers"],
            num_heads=t["num_attention_heads"], intermediate_size=t["intermediate_size"],
            max_position_embeddings=t["max_position_embeddings"], hidden_act=t["hidden_act"],
            penultimate_output=True, projection_dim=t.get("projection_dim", 0))

    vision = CLIPVisionConfig(
        hidden_size=i["hidden_size"], num_layers=i["num_hidden_layers"], num_heads=i["num_attention_heads"],
        intermediate_size=i["intermediate_size"], image_size=i["image_size"], patch_size=i["patch_size"])
    return dict(unet_config=unet, vae_config=vae, text_config=text(cfg["text_encoder"]),
                text_config_2=text(cfg["text_encoder_2"]), vision_config=vision,
                extra_num_tokens=pv["extra_num_tokens"], image_encoder_layers_idx=tuple(pv["image_encoder_layers_idx"]))


def program_models(cfg: Dict, device, kernels: bool = True):
    """The program's SDXL PhotoVerseModels for `cfg`, empty (built on the
    meta device, then allocated on `device`): the caller fills it.
    `kernels` False turns the hand-written kernel routes off (the CPU)."""
    import dataclasses

    from photoverse_tpu_torch.models.assembly import build_models

    kw = _port_configs(cfg)
    if not kernels:
        kw["unet_config"] = dataclasses.replace(kw["unet_config"], use_flash_attention=False, fused_blocks=False)
        kw["vae_config"] = dataclasses.replace(kw["vae_config"], use_flash_attention=False)
    models = build_models(dtype=DTYPES[cfg["precision"]], device="meta", **kw)
    return models.to_empty(device=device)


def ref_cfg(cfg: Dict) -> Dict[str, Dict]:
    """The SDXL reference's shape dictionaries for `cfg`."""
    u, v, i, pv = (cfg[k] for k in ("unet", "vae", "vision_encoder", "photoverse"))
    t1, t2 = cfg["text_encoder"], cfg["text_encoder_2"]
    return {
        "unet": {"channels": list(u["block_out_channels"]), "layers_per_block": u["layers_per_block"],
                 "heads": list(u["attention_head_dim"]), "depth": list(u["transformer_layers_per_block"]),
                 "attention": ["CrossAttn" in t for t in u["down_block_types"]],
                 "groups": u["norm_num_groups"],
                 "time_ids_dim": u["addition_time_embed_dim"],
                 "lora": (pv["lora_rank"], pv["lora_alpha"]) if pv["lora_rank"] else None},
        "vae": {"channels": list(v["block_out_channels"]), "layers_per_block": v["layers_per_block"],
                "groups": v["norm_num_groups"], "scaling_factor": v["scaling_factor"]},
        "text": {"layers": t1["num_hidden_layers"], "heads": t1["num_attention_heads"], "act": t1["hidden_act"]},
        "text_2": {"layers": t2["num_hidden_layers"], "heads": t2["num_attention_heads"], "act": t2["hidden_act"],
                   "projection": bool(t2.get("projection_dim"))},
        "vision": {"layers": i["num_hidden_layers"], "heads": i["num_attention_heads"], "patch": i["patch_size"],
                   "collect": list(pv["image_encoder_layers_idx"])},
    }


def latent_size(cfg: Dict) -> int:
    return cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)


class SDXLServeCell(serving.ServeCell):
    """The service of one SDXL serving cell and its requests."""

    def __init__(self, run):
        import torch

        self.run = run
        self.torch = torch
        cfg, wl = run.config, run.workload
        self.req_cfg = wl["requests"]
        self.server = wl["server"]
        dev = run.device
        with run.spans.span("build models"):
            self.models = program_models(cfg, dev, kernels=dev.type == "cuda")
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

    def make_request(self, index: int, n=None, stream: int = 0) -> Request:
        """serving.py's request `index` of stream `stream`, one id sequence
        for both text encoders, with each row's time ids."""
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
        res = cfg["resolution"]
        example = {
            "pixel_values": np.zeros((n, 1, 1, 3), np.float32),
            "pixel_values_clip": np.stack(crops).astype(np.float32),
            "text_input_ids": np.stack(ids).astype(np.int32),
            "concept_placeholder_idx": np.asarray(pidx, np.int32),
            # not read: the unconditional prompt of an SDXL bundle is zeros
            "negative_text_input_ids": neg,
            "add_time_ids": np.tile(np.asarray([res, res, 0, 0, res, res], np.float32), (n, 1)),
        }
        seed = int(rng.integers(0, 1 << 62))
        return Request(index, seed, n, self.key, example)


# ---------------------------------------------------------------------------
# the check


def reference_images(weights, cfg: Dict, reqs: List[Request], device, numerics: str = "f32",
                     rows_per_call: int = 4) -> List[np.ndarray]:
    """The SDXL reference's uint8 images for `reqs` (each (n, H, W, 3)),
    from the same inputs and the same noise seeds, `rows_per_call` rows a
    call."""
    import torch

    from benchmark.reference import nets, sdxl_nets

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
    keys = ("pixel_values_clip", "text_input_ids", "concept_placeholder_idx", "add_time_ids")
    with torch.no_grad(), nets.strict_f32():
        for i in range(0, len(rows), rows_per_call):
            part = rows[i:i + rows_per_call]
            ex = {k: np.stack([r.example[k][j] for r, j, _ in part]) for k in keys}
            imgs = sdxl_nets.generate(W, N, rc, ex, torch.stack([z for _, _, z in part]), steps, guidance, device)
            for (r, j, _), im in zip(part, imgs):
                out[id(r)][j] = im
    return [np.stack(out[id(r)]) for r in reqs]


def check(run, cell: SDXLServeCell, done: List[Request]) -> Dict[str, dict]:
    """Compare a sample of the window's served requests, drawn from the
    seed, with the reference; {name: {value, limit}}. Prints the
    reference's seconds per checked request."""
    spec = run.workload["correct"]
    rng = np.random.default_rng([run.seed % (1 << 63), 7])
    pool = sorted(done, key=lambda r: r.index)
    k = min(spec["sample"], len(pool))
    pick = [pool[i] for i in sorted(rng.choice(len(pool), size=k, replace=False))] if k else []
    checks: Dict[str, dict] = {"requests_checked": {"value": k, "limit": spec["sample"], "rule": ">="}}
    if not pick:
        return checks
    t = time.perf_counter()
    ref = reference_images(cell.weights, run.config, pick, run.device)
    print(f"[bench] reference: {(time.perf_counter() - t) / k:.2f} s a checked request", flush=True)
    checks.update(judge(spec["limits"], [r.images for r in pick], ref))
    return checks


# ---------------------------------------------------------------------------
# one run


def run_cell(run, drive) -> tuple:
    """serving.run_cell for an SDXL configuration: set up, warm up, measure
    the window that `drive` fills, then check. Returns (result, checks)."""
    from benchmark import flops_sdxl
    from benchmark.trace import Profile

    torch = __import__("torch")
    cell = SDXLServeCell(run)
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
    per_image = flops_sdxl.generation(run.config, steps, guidance)
    images = harness.prorated([(r.t_submit, r.t_done, r.n) for r in reqs if r.ok], t0, t1)
    print(f"[bench] window: {serving.describe(reqs)}", flush=True)
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


# ---------------------------------------------------------------------------
# the control


def control(run, numerics: str = "fp8") -> dict:
    """The `numerics` reference in the program's place on the cell's first
    `sample` requests of the seed, judged against the f32 reference by the
    cell's own limits: {correct, checks, reference_s_per_request}."""
    meta = program_models(run.config, "meta")
    weights = make_weights(named_params(meta), run.seed, run.device, DTYPES[run.config["precision"]])
    cell = SDXLServeCell.__new__(SDXLServeCell)
    cell.run, cell.req_cfg = run, run.workload["requests"]
    cell.key = (cell.req_cfg["steps"], float(cell.req_cfg["guidance"]), cell.req_cfg["scheduler"])
    reqs = [cell.make_request(i) for i in range(run.workload["correct"]["sample"])]
    t = time.perf_counter()
    ref = reference_images(weights, run.config, reqs, run.device, "f32")
    t_ref = (time.perf_counter() - t) / len(reqs)
    low = reference_images(weights, run.config, reqs, run.device, numerics)
    checks = judge(run.workload["correct"]["limits"], low, ref)
    return {"correct": passed(checks), "checks": checks, "reference_s_per_request": t_ref}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the fp8 control of an SDXL serving cell's check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    spec = harness.benchmark_spec()
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=0, trace=0)
        run = harness.Run(ns, spec, wl, cfg, time.perf_counter(), dev)
        print(json.dumps({"workload": args.workload, "seed": seed, "fp8": control(run)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
