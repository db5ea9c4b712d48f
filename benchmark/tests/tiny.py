"""A tiny configuration of the same schema as benchmark/configs/, and runs
of the harness on the CPU (the program in f32 on its plain paths)."""

from __future__ import annotations

import argparse
import copy
import time

import torch

from benchmark import harness

TINY = {
    "name": "tiny",
    "precision": "f32",
    "flags": {"use_flash_attention": False, "fast_attention_scores": False, "fast_norms": False,
              "fused_blocks": False, "remat": False},
    "resolution": 32,
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64], "layers_per_block": 1,
             "cross_attention_dim": 32, "attention_head_dim": 2, "norm_num_groups": 8, "sample_size": 16},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": [32, 64],
            "layers_per_block": 1, "norm_num_groups": 8, "scaling_factor": 0.18215, "sample_size": 32},
    "text_encoder": {"vocab_size": 128, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                     "intermediate_size": 64, "max_position_embeddings": 77,
                     "bos_token_id": 126, "eos_token_id": 127},
    "vision_encoder": {"hidden_size": 48, "num_hidden_layers": 4, "num_attention_heads": 2,
                       "intermediate_size": 64, "image_size": 28, "patch_size": 14},
    "photoverse": {"extra_num_tokens": 4, "image_encoder_layers_idx": [1, 2, 3, 4], "adapter_hidden_dim": 1024,
                   "lora_rank": 4, "lora_alpha": 1.0, "lora_dropout": 0.1,
                   "lora_target_modules": ["attn2.to_q", "attn2.to_k", "attn2.to_v"]},
}

SERVE_WL = {
    "config": "tiny", "traffic": "tiny-mix", "kind": "open_loop",
    "server": {"dynamic_batching": True, "max_batch": 4, "batch_wait_ms": 25, "max_queue": 64,
               "warm_batches": [1, 2, 4]},
    "requests": {"num_samples": 1, "steps": 3, "guidance": 6.0, "scheduler": "dpm",
                 "placeholder_positions": [2, 10]},
    "rate": 4.0,
    "correct": {"sample": 3, "limits": {"image_gap_mean": 0.5, "image_gap_max": 2.0}},
}


def tiny_config(**over):
    cfg = copy.deepcopy(TINY)
    cfg.update(over)
    return cfg


def spec_for(wl_name: str, e2e=("setup_s", "latency_p50_s", "latency_p90_s", "images_per_s"), per_layer=()):
    return {
        "workloads": [{"name": wl_name, "config": "tiny", "traffic": "tiny-mix", "chips": 1, "why": "test"}],
        "end_to_end": [{"name": n, "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}
                       for n in e2e],
        "per_layer": [{"name": n, "unit": "%", "better": "higher", "source": "host_clock", "layer": "x",
                       "moves": "setup_s"} for n in per_layer],
    }


def make_run(wl: dict, cfg: dict = None, seed: int = 3, seconds: float = 2.0, trace: int = 0, name="tiny-cell",
             per_layer=()):
    wl = dict(copy.deepcopy(wl), name=name)
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)
    return harness.Run(args, spec_for(name, per_layer=per_layer), wl, cfg or tiny_config(),
                       time.perf_counter(), torch.device("cpu"))


def tiny_train_config(**over):
    cfg = tiny_config(**over)
    cfg["flags"] = dict(cfg["flags"], remat=True)
    cfg["recipe"] = {
        "train_batch_size": 8, "micro_batch": 4, "accumulation": 2, "face_rows": 2,
        "face_loss_sample_ratio": 0.25, "face_steps": 3, "face_guidance": 2.0,
        "learning_rate": 1e-3, "lr_scheduler": "constant", "lr_warmup_steps": 500, "max_train_steps": 40000,
        "adam_beta1": 0.9, "adam_beta2": 0.999, "adam_weight_decay": 0.01, "adam_epsilon": 1e-08,
        "max_grad_norm": 1.0, "concept_reg_weight": 0.01, "visual_reg_weight": 0.001, "face_loss_weight": 0.01,
        "lora_dropout": 0.1, "use_random_prompts": True, "uint8_transfer": True, "loader_workers": 2,
    }
    cfg["face_model"] = {"name": "arcface", "layers": [1, 1, 1, 1], "channels": [8, 16, 16, 16],
                         "embedding_dim": 16, "input_size": 32}
    cfg["dataset"] = {"identities": 12, "image_size": 64, "mask_size": 32}
    return cfg


TRAIN_WL = {
    "config": "tiny", "traffic": "tiny-mix", "kind": "train_steps",
    "correct": {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}},
}
