"""The work of one launch of csrc/dual_cross_attn.cu's kernel, the unfused
blocks' dual-context cross-attention: grid (ceil(S / 128), H, B). The
attending UNet level is the one whose token count S gives the grid's row
blocks and whose heads are H: a CrossAttn down level (the up levels repeat
their shapes) or the mid block at the deepest level. d is the level's
channels over its heads; the context is the text encoder's positions and
the serving path's one identity row (token_index 0). The work is
`bounds.flash_fwd` over St + K keys: q, the context K and V and the output
once, and the two products."""

from benchmark import bounds

ROWS = 128  # query rows a block


def _levels(cfg):
    """(S, H, d) of every attending level: the down levels with
    cross-attention, then the mid block."""
    u = cfg["unet"]
    ch = u["block_out_channels"]
    n = len(ch)
    kinds = u.get("down_block_types", ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"])  # SD-1.5's
    heads = u["attention_head_dim"]
    heads = heads if isinstance(heads, list) else [heads] * n
    size = cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    attending = [i for i, kind in enumerate(kinds) if "CrossAttn" in kind] + [n - 1]
    return [((size >> i) ** 2, heads[i], ch[i] // heads[i]) for i in attending]


def work(launch, match, cfg):
    gx, gy, gz = launch["grid"][:3]
    found = {(S, H, d) for S, H, d in _levels(cfg) if -(-S // ROWS) == gx and H == gy}
    if len(found) != 1:
        raise ValueError(f"dual_cross_attn launch grid {launch['grid']} matches "
                         f"{'no' if not found else 'more than one'} attending UNet level")
    (S, H, d), = found
    St, K = cfg["text_encoder"]["max_position_embeddings"], 1
    return bounds.flash_fwd(gz, S, St + K, H, d)
