"""Count the SASS instructions of built kernels by opcode.

    python -m audio_tokens_tpu_torch.tools.sass_ops build/kernels/lib<name>.so
        [PART ...]

Runs ``cuobjdump -sass`` on the library (the CUDA toolkit's, found beside
nvcc) and prints, for each kernel whose mangled name contains one of the
PARTs (every kernel without any), the number of instructions of each opcode
in its code, most frequent first.  The counts are of the code as written
out, not of instructions executed: they show what a source construct
compiles to (``cvt.rna.tf32.f32``, for instance, becomes FSETP and SEL
around the conversion), which ``ptxas -v`` does not.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable

from audio_tokens_tpu_torch.ops import _build


def opcode_counts(sass: str, parts: Iterable[str] = ()) -> Dict[str, collections.Counter]:
    """{kernel's mangled name: Counter of opcodes} from ``cuobjdump -sass``
    output, for the kernels whose names contain one of ``parts`` (all if
    none).  A predicate (``@P0``, ``@!UP1``) is not counted as the opcode."""
    parts = tuple(parts)
    counts = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if parts and not any(p in name for p in parts):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                         block)
        counts[name] = collections.Counter(ops)
    return counts


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", sys.argv[1]], check=True,
                          capture_output=True, text=True).stdout
    for name, ops in opcode_counts(sass, sys.argv[2:]).items():
        print(f"{name}: {sum(ops.values())} instructions")
        print("  " + ", ".join(f"{op} {n}" for op, n in ops.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
