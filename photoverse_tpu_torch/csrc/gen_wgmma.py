"""Writes wgmma_gen.cuh: one inline-PTX wrapper per wgmma shape the kernels use.

    python3 photoverse_tpu_torch/csrc/gen_wgmma.py

An asm statement names every accumulator register, so each width N needs
its own statement; this script spells them out. `ss`: A and B from shared
memory (both K-major). `rs`: A from registers, B from shared memory in
MN-major order (the transpose bit set). `rsk`: A from registers, B from
shared memory K-major. All are m64nNk16, bf16 operands, f32 accumulators
(N / 2 per thread).
"""

import os

SS = (64, 80)       # 64 x 64 score tiles (q k^T, g v^T and their transposes); the fused tail's products
RSK = (64,)         # the backward's score tiles with the block's own rows held in registers
RS = (40, 64, 80, 256)  # p v at head dims 40, 64 and 80 and the backward's ds k, p^T g, ds^T q at 40 and 80;
                        # half of d = 512

HEAD = """// Generated by gen_wgmma.py; edit that script, not this file.
// m64nNk16 bf16 wgmma with f32 accumulators, N / 2 registers a thread:
// d[4 j + {0, 1}] = D[g][8 j + 2 t + {0, 1}], d[4 j + {2, 3}] = D[g + 8][same],
// for warp w of the warpgroup rows 16 w + g, with g = lane / 4, t = lane % 4.
#pragma once

#include <stdint.h>

namespace pv {
"""


def regs(n):
    return ", ".join(f"%{i}" for i in range(n))


def outs(n):
    lines = []
    for i in range(0, n, 8):
        lines.append(", ".join(f'"+f"(d[{j}])' for j in range(i, min(i + 8, n))))
    return ",\n        ".join(lines)


def ss(n):
    r = n // 2
    return f"""
// D (64 x {n}) = A (64 x 16, shared, K-major) B^T (B {n} x 16, shared, K-major) + (acc ? D : 0)
__device__ __forceinline__ void wgmma_ss_n{n}(float (&d)[{r}], uint64_t a, uint64_t b, int acc) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {outs(r)}
      : "l"(a), "l"(b), "r"(acc));
}}
"""


def rs(n, kmajor=False):
    r = n // 2
    what = f"B^T (B {n} x 16, shared, K-major)" if kmajor else f"B (16 x {n}, shared, N contiguous)"
    name = "rsk" if kmajor else "rs"
    return f"""
// D (64 x {n}) = A (64 x 16, registers) {what} + (acc ? D : 0)
__device__ __forceinline__ void wgmma_{name}_n{n}(float (&d)[{r}], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs(r)}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, {0 if kmajor else 1};\\n}}\\n"
      : {outs(r)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}}
"""


def dispatch(kind, ns, args, call):
    out = f"\ntemplate <int N>\n__device__ __forceinline__ void wgmma_{kind}(float (&d)[N / 2], {args}, int acc) {{\n"
    for i, n in enumerate(ns):
        out += f"  {'if' if i == 0 else 'else if'} constexpr (N == {n}) wgmma_{kind}_n{n}(d, {call}, acc);\n"
    out += "  else static_assert(N == 0, \"no wgmma wrapper of this width\");\n}\n"
    return out


def main():
    text = HEAD
    text += "".join(ss(n) for n in SS) + "".join(rs(n) for n in RS) + "".join(rs(n, True) for n in RSK)
    text += dispatch("ss", SS, "uint64_t a, uint64_t b", "a, b")
    text += dispatch("rs", RS, "const uint32_t (&a)[4], uint64_t b", "a, b")
    text += dispatch("rsk", RSK, "const uint32_t (&a)[4], uint64_t b", "a, b")
    text += "\n}  // namespace pv\n"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wgmma_gen.cuh")
    with open(path, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
