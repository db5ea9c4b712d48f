"""At a tiny size on the CPU: the SDXL serving cell's whole run (its
bundle, requests with time ids, the SDXL reference's check, its FLOP count
against torch's counter), and the bursty traffic kind `on_off` (its
schedule and a run; no cell uses it yet)."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from benchmark import flops_sdxl, harness
from benchmark.tests.tiny import SERVE_WL, make_run
from benchmark.traffic import on_off

TINY_SDXL = {
    "name": "tiny-sdxl",
    "precision": "f32",
    "flags": {"use_flash_attention": False, "fast_attention_scores": False, "fast_norms": False,
              "fused_blocks": False, "remat": False},
    "resolution": 32,
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64, 64],
             "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
             "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
             "layers_per_block": 1, "transformer_layers_per_block": [1, 1, 2], "cross_attention_dim": 64,
             "attention_head_dim": [4, 8, 8], "use_linear_projection": True, "addition_embed_type": "text_time",
             "addition_time_embed_dim": 8, "projection_class_embeddings_input_dim": 64, "norm_num_groups": 8,
             "sample_size": 16},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": [32, 64],
            "layers_per_block": 1, "norm_num_groups": 8, "scaling_factor": 0.13025, "sample_size": 32},
    "text_encoder": {"vocab_size": 128, "hidden_size": 24, "num_hidden_layers": 2, "num_attention_heads": 3,
                     "intermediate_size": 48, "max_position_embeddings": 77, "hidden_act": "quick_gelu",
                     "bos_token_id": 126, "eos_token_id": 127},
    "text_encoder_2": {"vocab_size": 128, "hidden_size": 40, "num_hidden_layers": 2, "num_attention_heads": 5,
                       "intermediate_size": 80, "max_position_embeddings": 77, "hidden_act": "gelu",
                       "projection_dim": 16, "bos_token_id": 126, "eos_token_id": 127},
    "vision_encoder": {"hidden_size": 48, "num_hidden_layers": 2, "num_attention_heads": 2,
                       "intermediate_size": 64, "image_size": 28, "patch_size": 14},
    "photoverse": {"extra_num_tokens": 0, "image_encoder_layers_idx": [], "adapter_hidden_dim": 1024,
                   "lora_rank": 4, "lora_alpha": 1.0,
                   "lora_target_modules": ["attn2.to_q", "attn2.to_k", "attn2.to_v"]},
}

SDXL_WL = {
    "config": "tiny-sdxl", "traffic": "tiny-mix", "kind": "closed_loop_sdxl", "clients": 4,
    "server": {"dynamic_batching": True, "max_batch": 2, "batch_wait_ms": 25, "max_queue": 64,
               "warm_batches": [1, 2]},
    "requests": {"num_samples": 1, "steps": 2, "guidance": 5.0, "scheduler": "dpm",
                 "placeholder_positions": [2, 10]},
    "correct": {"sample": 2, "limits": {"image_gap_mean": 0.5, "image_gap_max": 2.0}},
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_the_sdxl_file_names_the_published_model():
    cfg = harness.config("sdxl-photoverse-serve")
    u = cfg["unet"]
    assert cfg["reduced"] == [] and cfg["resolution"] == 1024 and u["cross_attention_dim"] == 2048
    blocks = 2 * sum(d for d, t in zip(u["transformer_layers_per_block"], u["down_block_types"]) if "CrossAttn" in t)
    blocks += 3 * sum(d for d, t in zip(u["transformer_layers_per_block"], u["down_block_types"]) if "CrossAttn" in t)
    assert blocks + u["transformer_layers_per_block"][-1] == 70
    assert [c // h for c, h in zip(u["block_out_channels"], u["attention_head_dim"])] == [64, 64, 64]
    assert cfg["text_encoder"]["hidden_size"] + cfg["text_encoder_2"]["hidden_size"] == 2048
    # 6.76 TFLOP a UNet evaluation at 128^2, as torch's counter reads the port's UNet on the meta device
    p = flops_sdxl.unet_parts(cfg, 128, 77, 1)
    assert (p["main"] + p["context"]) / 1e12 == pytest.approx(6.7623, rel=1e-4)


def test_the_sdxl_flop_count_equals_torchs_counter_at_the_tiny_size():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import serving_sdxl

    cfg = copy.deepcopy(TINY_SDXL)
    cfg["photoverse"]["lora_rank"] = 0  # the count folds LoRA into its base projections
    models = serving_sdxl.program_models(cfg, "meta", kernels=False)
    p = flops_sdxl.unet_parts(cfg, 16, 77, 1)
    with torch.device("meta"), FlopCounterMode(display=False) as fc, torch.no_grad():
        models.unet(torch.randn(1, 16, 16, 4), torch.tensor([3]), torch.randn(1, 77, 64), torch.randn(1, 1, 64),
                    added_cond=(torch.randn(1, 16), torch.randn(1, 6)))
    # within 0.1%: the counter leaves out the one-row time-embedding products
    assert fc.get_total_flops() == pytest.approx(p["main"] + p["context"], rel=1e-3)


def test_a_sound_sdxl_serving_run():
    run = make_run(SDXL_WL, cfg=copy.deepcopy(TINY_SDXL), seconds=1.5)
    run.end_to_end = [{"name": "setup_s", "unit": "s"}, {"name": "images_per_s", "unit": "images/s"}]
    result, checks = harness.traffic(run.workload["kind"]).run(run)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 4
    assert set(result["metrics"]) == {"setup_s", "images_per_s"}
    assert checks["requests_checked"]["value"] == 2 and checks["image_gap_max"]["value"] <= 1.0


def test_on_off_bursts_start_the_window_and_keep_the_rate():
    due = on_off.offsets(8.4, 4.0, 6.0, 51.0, 2**31 + 7)
    phases = np.asarray(due) // 10
    assert due[0] == 0.0 and all(x % 10 < 4 for x in due)
    assert [int((phases == k).sum()) for k in range(6)] == [34] * 5 + [8]  # the last burst cut at 51 s
    assert sorted(due) == due and due != on_off.offsets(8.4, 4.0, 6.0, 51.0, 2**31 + 8)
    assert on_off.offsets(8.4, 4.0, 6.0, 51.0, 5) == on_off.offsets(8.4, 4.0, 6.0, 51.0, 5)


def test_a_sound_bursty_run():
    wl = dict(copy.deepcopy(SERVE_WL), kind="on_off", rate=6.0, on_s=0.5, off_s=0.5)
    run = make_run(wl, seconds=2.0)
    result, checks = harness.traffic(run.workload["kind"]).run(run)
    assert result["correct"], checks
    assert result["attempted"] == 6 and result["failed"] == 0  # two bursts of 3
    assert {"latency_p50_s", "latency_p90_s"} <= set(result["metrics"])


def test_the_sdxl_cells_file_agrees_with_the_benchmark():
    spec = harness.benchmark_spec()
    cell = next(w for w in spec["workloads"] if w["name"] == "sdxl-serve-saturated-g5")
    wl = harness.workload("sdxl-serve-saturated-g5")
    assert (wl["config"], wl["traffic"], cell["chips"]) == (cell["config"], cell["traffic"], 1)
    assert wl["clients"] == 2 * wl["server"]["max_batch"] and wl["server"]["warm_batches"] == [1, 2, 4]
    json.dumps(spec)
