"""The work of one launch of csrc/fused_cross_ff.cu's kernel: grid
(ceil(S / 64), B); the block tail at the UNet's first level (C channels,
S = latent^2 tokens), 77 text and 1 identity context tokens (the serving
path's token_index 0), GEGLU width 4C."""

from benchmark import bounds


def work(launch, match, cfg):
    gx, gy = launch["grid"][0], launch["grid"][1]
    size = cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    S = size * size
    if gx != -(-S // 64):
        raise ValueError(f"fused_cross_ff launch grid {launch['grid']} does not cover {S} tokens")
    u = cfg["unet"]
    C = u["block_out_channels"][0]
    return bounds.fused_cross_ff(gy, S, C, u["attention_head_dim"],
                                 cfg["text_encoder"]["max_position_embeddings"], 1, 4 * C)
