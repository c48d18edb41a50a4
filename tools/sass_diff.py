"""Compare the SASS of kernels between two builds of the port's library.

    python3 tools/sass_diff.py LIB_A LIB_B [--match NAME,...]

Disassembles both shared libraries with cuobjdump -sass (beside nvcc) and,
for every kernel function present in both whose mangled name contains one
of the --match substrings (default: every kernel of the port, all in the
istvt namespace), prints whether its instructions are the same (addresses and the
scheduling comments dropped), with both instruction counts; the last line
counts the same and the differing functions. Used to show that a change
left a kernel's machine code as it was.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys


def functions(lib: str, cuobjdump: str) -> dict:
    """{mangled name: [instruction, ...]} of a library's SASS."""
    out = subprocess.run([cuobjdump, "-sass", lib], check=True,
                         capture_output=True, text=True).stdout
    fns, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            fns[cur] = []
        elif cur is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            fns[cur].append(re.sub(r"/\*[0-9a-f]+\*/", "",
                                   line.split(";")[0]).strip())
    return fns


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--match", default="istvt")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from istvt_tpu_torch.kernels import _lib
    tool = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    a, b = functions(args.lib_a, tool), functions(args.lib_b, tool)
    keys = args.match.split(",")
    same = diff = 0
    for name in sorted(set(a) & set(b)):
        if not any(k in name for k in keys):
            continue
        eq = a[name] == b[name]
        same, diff = same + eq, diff + (not eq)
        print(f"{'same' if eq else 'DIFF'} {len(a[name])} {len(b[name])} "
              f"{name}")
    print(f"SASS same {same} diff {diff}")


if __name__ == "__main__":
    main()
