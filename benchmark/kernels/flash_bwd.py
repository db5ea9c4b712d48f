"""The work of one call of csrc/flash_bwd.cu: a dq kernel and a dk/dv
kernel, each on grid (S / block, B * H). The call's whole bound is
counted at its dq launch (head dim D from the template, S from the UNet
level whose channels give that head dim, B from the grid); the dk/dv
launch adds its time and no work."""

from benchmark import bounds


def work(launch, match, cfg):
    if "dkv" in launch["name"]:
        return 0.0, 0.0
    D = int(match.group(1))
    u = cfg["unet"]
    H = u["attention_head_dim"]
    size = cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    level = [c // H for c in u["block_out_channels"]].index(D)
    S = (size >> level) ** 2
    B = launch["grid"][1] // H
    return bounds.flash_bwd(B, S, H, D)
