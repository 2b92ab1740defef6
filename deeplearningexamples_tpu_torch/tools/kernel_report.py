"""What nvcc makes of the hand-written kernels, per kernel: registers, spills
and static shared memory (``ptxas -v``), and the count of tensor-core (HMMA),
FMA (FFMA), ``ldmatrix`` (LDSM) and ``cp.async`` (LDGSTS) instructions in its
SASS (``cuobjdump -sass``).

``python -m deeplearningexamples_tpu_torch.tools.kernel_report [--out F]
[source ...]`` compiles ``csrc/*.cu`` (or the sources named, by file name)
with the flags the port builds them with. It needs the CUDA toolkit (nvcc,
cuobjdump and cu++filt), not a card, and prints one JSON object per kernel.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
from pathlib import Path

from ..ops import _build

SASS_OPS = ("HMMA", "FFMA", "LDSM", "LDGSTS")
_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def _tool(name: str) -> str:
    return str(Path(_build.nvcc()).with_name(name))


def _demangle(names: list[str]) -> dict[str, str]:
    out = subprocess.run([_tool("cu++filt"), *names], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def report(src: Path) -> list[dict]:
    """One dict per kernel of ``src``."""
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / f"{src.stem}.o"
        res = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(obj), str(src)], capture_output=True, text=True, check=True)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
    kernels: dict[str, dict] = {}
    current = None
    for line in res.stderr.splitlines():
        if m := _ENTRY.search(line):
            current = kernels.setdefault(m.group(1), {})
        elif current is not None:
            if m := _USED.search(line):
                current["registers"] = int(m.group(1))
                if s := _SMEM.search(line):
                    current["static_smem_bytes"] = int(s.group(1))
            elif m := _SPILL.search(line):
                current["stack_bytes"], current["spill_stores"], \
                    current["spill_loads"] = map(int, m.groups())
    current = None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\w+)", line):
            current = kernels.setdefault(m.group(1), {})
            current.update(dict.fromkeys(SASS_OPS, 0))
        elif current is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    current[op] += 1
    names = _demangle(list(kernels))
    return [{"source": src.name, "kernel": names[k], **v}
            for k, v in sorted(kernels.items(), key=lambda kv: names[kv[0]])]


def main() -> None:
    parser = argparse.ArgumentParser(__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="*", help="file names under csrc/")
    parser.add_argument("--out", default=None, help="a JSON file for the results")
    args = parser.parse_args()
    sources = ([_build.CSRC / s for s in args.sources] if args.sources
               else sorted(_build.CSRC.glob("*.cu")))
    rows = [r for src in sources for r in report(src)]
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
