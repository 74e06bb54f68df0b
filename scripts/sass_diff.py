#!/usr/bin/env python3
"""Compare the machine code of K2's instantiations between two checkouts.

    python3 scripts/sass_diff.py --base DIR [--tree DIR]

Compiles ``scheduler_tpu_torch/csrc/mega_allocate.cu`` of the checkout at
``--base`` and of ``--tree`` (this one by default) to cubins, both with this
checkout's ``nvcc`` flags (``ops/cuda_build.py``), reads each kernel entry's SASS with
``cuobjdump -sass`` and its registers with ``cuobjdump -res-usage``, and
prints one JSON line per instantiation of ``mega_allocate_kernel`` in the
base: the tree's instantiation of the same modes (the base's template
arguments, every template argument the base lacks false), whether its
instructions are the same (addresses and encodings aside; else the first
that differs) and both register counts.  Needs the CUDA toolkit (the machine with the card);
exits 2 without ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scheduler_tpu_torch.ops.cuda_build import NVCC_FLAGS  # noqa: E402

ENTRY = re.compile(r"_Z20mega_allocate_kernelI((?:Lb[01]E)+)Ev8MegaArgs")


def _tool(name: str) -> str:
    found = shutil.which(name) or os.path.join("/usr/local/cuda/bin", name)
    if not os.path.exists(found):
        print(f"sass_diff: {name} not found", file=sys.stderr)
        raise SystemExit(2)
    return found


def entries(tree: str, out_dir: str):
    """{template arguments (a tuple of bools): (instructions, registers)}
    of every mega_allocate_kernel entry of ``tree``'s source."""
    cubin = os.path.join(out_dir, "mega_allocate.cubin")
    src = os.path.join(tree, "scheduler_tpu_torch", "csrc", "mega_allocate.cu")
    subprocess.run([_tool("nvcc"), *NVCC_FLAGS, "-cubin", "-o", cubin, src], check=True)
    cuobjdump = _tool("cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    usage = subprocess.run([cuobjdump, "-res-usage", cubin], check=True, capture_output=True,
                           text=True).stdout
    code, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            code[name] = []
        elif name is not None and "/*" in line and ";" in line:
            # "/*0010*/   MOV R1, c[0x0][0x28] ;   /* 0x... */": the instruction.
            code[name].append(line.split("*/", 1)[1].split(";")[0].strip())
    regs = {}
    for name, line in re.findall(r"Function (\S+):\n\s*(.*)", usage):
        found = re.search(r"REG:(\d+)", line)
        regs[name] = int(found.group(1)) if found else None
    out = {}
    for name, instrs in code.items():
        match = ENTRY.fullmatch(name)
        if match:
            args = tuple(bit == "1" for bit in re.findall(r"Lb([01])E", match.group(1)))
            out[args] = (instrs, regs.get(name))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True)
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    opts = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "base"))
        os.makedirs(os.path.join(tmp, "tree"))
        base = entries(os.path.abspath(opts.base), os.path.join(tmp, "base"))
        tree = entries(os.path.abspath(opts.tree), os.path.join(tmp, "tree"))
    width = max(len(args) for args in tree)
    same_all = True
    for args, (instrs, regs) in sorted(base.items()):
        mine = tree.get(args + (False,) * (width - len(args)))
        same = mine is not None and mine[0] == instrs
        same_all &= same
        rec = {"instantiation": [int(a) for a in args], "same_sass": same,
               "instructions": [len(instrs), len(mine[0]) if mine else None],
               "registers": [regs, mine[1] if mine else None]}
        if mine is not None and not same:
            at = next((i for i, (x, y) in enumerate(zip(instrs, mine[0])) if x != y),
                      min(len(instrs), len(mine[0])))
            rec["first_difference"] = [at, instrs[at:at + 3], mine[0][at:at + 3]]
        print(json.dumps(rec), flush=True)
    print(json.dumps({"sass_identical": same_all}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
