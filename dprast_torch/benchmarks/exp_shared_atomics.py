"""The shared-memory atomics B1 could add its window with, on one CUDA
card: builds `shared_atomics.cu` (a standalone program beside this
script) with `nvcc` for ``sm_90a`` into ``build/exp_shared_atomics/``,
prints what each form's adds compiled to (`cuobjdump -sass`: the ATOMS
instructions per kernel) and runs it: per form (an fp32 `atomicAdd`, a
64-bit integer `atomicAdd`, two 32-bit planes with a carry) the
milliseconds of one launch and the adds per ns and SM, at 512 and 1,024
threads a block.  The card's name and power limit come first.

Usage, from the root of the repository:

    python3 -m dprast_torch.benchmarks.exp_shared_atomics
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

from dprast_torch.ops import _build
from dprast_torch.utils import profiling

_SOURCE = Path(__file__).resolve().with_name("shared_atomics.cu")
_OUT = Path(__file__).resolve().parents[2] / "build" / "exp_shared_atomics"


def sass_lines(binary: Path, nvcc: str) -> list[str]:
    """The distinct ATOMS instructions of each kernel of `binary`."""
    sass = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(binary)],
        capture_output=True, text=True, check=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            continue
        op = re.search(r"\s(ATOMS[.\w]*)\s", line)
        if name and op:
            ops = found.setdefault(name, {})
            ops[op.group(1)] = ops.get(op.group(1), 0) + 1
    return [f"SASS {k}: " + ", ".join(f"{o} x{n}" for o, n in v.items())
            for k, v in found.items()]


def main():
    print(profiling.card(0))
    _OUT.mkdir(parents=True, exist_ok=True)
    binary = _OUT / "shared_atomics"
    nvcc = _build._nvcc()
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", "-o", str(binary), str(_SOURCE)],
                   check=True)
    for line in sass_lines(binary, nvcc):
        print(line)
    print(subprocess.run([str(binary)], capture_output=True, text=True,
                         check=True).stdout, end="")


if __name__ == "__main__":
    main()
