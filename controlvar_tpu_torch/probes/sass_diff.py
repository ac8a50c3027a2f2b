"""Compare the SASS of one kernel's instances between two builds.

    python3 controlvar_tpu_torch/probes/sass_diff.py LIB_A LIB_B [--kernel NAME]

LIB_A and LIB_B are shared libraries that `ops/_build.py` built from two
checkouts of one source (e.g. `build/kernels/libdecode_attention_*.so` of a
parent unpacked with `git archive` and of the change). For every function
of LIB_A whose mangled name holds NAME (default: decode_attention_kernel,
the K1/K8 instances) it finds the function of LIB_B with the same name from
NAME on, and prints both instruction counts and how many instructions
differ (cuobjdump -sass, addresses and encodings stripped): 0 shows that a
change left those instances' machine code as it was. Needs the CUDA
toolkit's cuobjdump.
"""
from __future__ import annotations

import argparse
import difflib
import re
import shutil
import subprocess


def functions(lib: str) -> dict:
    """{mangled name: [instruction, ...]} of a library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and "/*" in line:
            ins = re.sub(r"/\*[^*]*\*/", "", line).strip()
            if ins:
                funcs[name].append(ins)
    return funcs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--kernel", default="decode_attention_kernel")
    args = ap.parse_args()
    tail = lambda name: name[name.index(args.kernel):]
    a = {tail(n): f for n, f in functions(args.lib_a).items() if args.kernel in n}
    b = {tail(n): f for n, f in functions(args.lib_b).items() if args.kernel in n}
    if not a:
        raise SystemExit(f"no function of {args.lib_a} holds {args.kernel}")
    for key, fa in sorted(a.items()):
        fb = b.get(key)
        if fb is None:
            print(f"{key}: missing from {args.lib_b}")
            continue
        diff = sum(1 for d in difflib.unified_diff(fa, fb, lineterm="", n=0)
                   if d[:1] in "+-" and d[:3] not in ("+++", "---"))
        print(f"{key}: {len(fa)} vs {len(fb)} instructions, {diff} differing")


if __name__ == "__main__":
    main()
