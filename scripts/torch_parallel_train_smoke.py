"""The parallel-train phase of chip_smoke.py alone, on one GPU: build the
kernels, hold kernels 2 and 3 at a tensor-parallel rank's shapes (the
kernel phase's rows for them), write the SD-1.5-layout model directory and
the identities, run phase_parallel_train (cli.train --recipe canonical
under --shard_optimizer_state, --tensor_parallel 2 and --fsdp on two gloo
ranks that share the card, the --fsdp run stopped by SIGTERM after step 1
and resumed). Exits 1 if a check fails.

    python3 scripts/torch_parallel_train_smoke.py [--no-kernels]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    smi = cs.phase_device()
    cs.phase_build()
    ok = True
    if "--no-kernels" not in sys.argv:
        rows = cs.phase_kernels(cs.TPU_KERNELS)
        ok = all(r["ok"] for r in rows)
    with tempfile.TemporaryDirectory() as tmp:
        root, data, _, _ = cs.write_user_files(tmp)
        ok = cs.phase_parallel_train(smi, root, data) and ok
    print("parallel-train phase", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
