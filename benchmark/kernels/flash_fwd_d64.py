"""The work of one launch of csrc/flash_fwd_wgmma.cu's kernel at head dim
64 (SDXL's self-attention, no lse): grid (ceil(Sq / 128), B * H). Sq is
the attending UNet level whose token count gives the grid's row blocks,
H that level's heads, B the grid's second axis over H; Skv = Sq."""

from benchmark import bounds

D = 64
BQ = 128  # query rows a block


def work(launch, match, cfg):
    gx, gy = launch["grid"][0], launch["grid"][1]
    u = cfg["unet"]
    size = cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    for level, kind in enumerate(u["down_block_types"]):
        S = (size >> level) ** 2
        if "CrossAttn" in kind and -(-S // BQ) == gx:
            H = u["attention_head_dim"][level]
            if gy % H:
                raise ValueError(f"flash d=64 launch grid {launch['grid']} is not a multiple of {H} heads")
            return bounds.flash_fwd(gy // H, S, S, H, D)
    raise ValueError(f"flash d=64 launch grid {launch['grid']} matches no attending UNet level")
