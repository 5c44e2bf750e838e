"""Compare the compiled kernels of two checkouts of the port: registers,
spills, stack and static shared memory of every kernel, from ``nvcc
-Xptxas -v``.

    python -m efficient_multimodal_perception_tpu_torch.tools.ptxas_compare \
        TREE_A TREE_B [--out report.json]

Each tree's kernels are built by that tree's own ``ops/_build.py`` (in a
process of its own, into its ``build/kernels/``), so the report holds
both trees' compiler output under the same toolkit.  It prints one line
per kernel the two trees share (``same`` or ``DIFF``), the kernels only
one tree has, and a JSON summary last; the exit code is 1 if a shared
kernel differs.  Kernels are matched by mangled name, so a kernel whose
template or parameter list changed counts as one tree's only.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse(log: str) -> dict:
    """kernel -> {registers, stack, spill_stores, spill_loads, smem}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            cur.update(registers=int(m.group(1)),
                       smem=int(m.group(2) or 0))
    return out


def build_log(tree: Path) -> str:
    """Build ``tree``'s kernels with its own ``ops/_build.py``; return
    its build log."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from efficient_multimodal_perception_tpu_torch.ops import "
            "_build; _build.build(); print(_build.build_dir())")
    res = subprocess.run([sys.executable, "-c", code, str(tree)],
                         capture_output=True, text=True, check=True)
    return (Path(res.stdout.strip().splitlines()[-1]) / "build.log").read_text()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a", type=Path)
    ap.add_argument("tree_b", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    a, b = (parse(build_log(t.resolve())) for t in (args.tree_a, args.tree_b))
    shared = sorted(set(a) & set(b))
    diff = [k for k in shared if a[k] != b[k]]
    for k in shared:
        print(f"{'DIFF' if k in diff else 'same'} {k}: {json.dumps(a[k])}"
              + (f" -> {json.dumps(b[k])}" if k in diff else ""))
    for name, only in (("A", sorted(set(a) - set(b))),
                       ("B", sorted(set(b) - set(a)))):
        for k in only:
            print(f"only {name} {k}: {json.dumps((a if name == 'A' else b)[k])}")
    summary = dict(shared=len(shared), differ=diff,
                   only_a=sorted(set(a) - set(b)),
                   only_b=sorted(set(b) - set(a)))
    if args.out:
        args.out.write_text(json.dumps(dict(summary, a=a, b=b), indent=1))
    print(json.dumps(summary))
    return 1 if diff else 0


if __name__ == "__main__":
    sys.exit(main())
