"""The identity phase of chip_smoke.py alone, on one GPU: build the
kernels, write the SD-1.5-layout model directory and the identities, run
phase_identity. About 3 minutes; exits 1 if a check fails.

    python3 scripts/torch_identity_smoke.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    smi = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        root, data, _ = cs.write_user_files(tmp)
        ok = cs.phase_identity(smi, root, data)
    print("identity phase", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
