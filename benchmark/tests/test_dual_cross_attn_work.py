"""The dual-context cross-attention kernel's work module on synthetic
launches: every attending level of both serving configurations (SD-1.5's
8^2 mid block included) against its bound computed by hand, the kernel's
name as the profiler writes it, and a grid that matches no level."""

from __future__ import annotations

import pytest

from benchmark import harness


def _work():
    files = harness.kernel_files("dual_cross_attn")
    assert len(files) == 1
    return files[0]


def _by_hand(B, S, H, d, keys=78):
    """q, k, v in and out once in bf16; 4 FLOPs a query, key and channel."""
    return 4 * B * H * S * keys * d, 2 * B * H * d * (2 * S + 2 * keys)


@pytest.mark.parametrize("config,B,S,H,d", [
    ("sd15-photoverse-serve", 16, 4096, 8, 40),    # 64^2 (the fused tail takes it while serving)
    ("sd15-photoverse-serve", 16, 1024, 8, 80),    # 32^2
    ("sd15-photoverse-serve", 16, 256, 8, 160),    # 16^2
    ("sd15-photoverse-serve", 16, 64, 8, 160),     # the 8^2 mid block, deeper than any down level with attention
    ("sd15-photoverse-serve", 1, 64, 8, 160),
    ("sdxl-photoverse-serve", 8, 4096, 10, 64),    # 64^2
    ("sdxl-photoverse-serve", 8, 1024, 20, 64),    # 32^2 and the mid block
    ("sdxl-photoverse-serve", 2, 1024, 20, 64),
])
def test_the_work_of_each_attending_level(config, B, S, H, d):
    f = _work()
    launch = {"grid": [-(-S // 128), H, B]}
    assert f["work"](launch, None, harness.config(config)) == _by_hand(B, S, H, d)


def test_the_pattern_reads_the_kernels_name_at_every_head_dim():
    f = _work()
    for d in (40, 64, 80, 160):
        assert f["pattern"].search(f"void (anonymous namespace)::dual_cross_attn_kernel<{d}>((anonymous "
                                   f"namespace)::Args)")
    assert not f["pattern"].search("void (anonymous namespace)::fused_cross_ff_kernel(Maps, Args)")


@pytest.mark.parametrize("config,grid", [
    ("sd15-photoverse-serve", [16, 8, 16]),   # no level has 2048 tokens
    ("sd15-photoverse-serve", [8, 10, 16]),   # 32^2 at 10 heads
    ("sdxl-photoverse-serve", [2, 20, 8]),    # SDXL has no 16^2 attention
])
def test_a_grid_that_matches_no_level_raises(config, grid):
    with pytest.raises(ValueError, match="matches no attending UNet level"):
        _work()["work"]({"grid": grid}, None, harness.config(config))
