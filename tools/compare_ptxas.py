"""Compare the ptxas reports of two checkouts' kernel libraries.

  python3 tools/compare_ptxas.py --parent DIR [--root DIR]

Builds every library of drt_tpu_torch/csrc in both checkouts (one nvcc a
source, all at once, each checkout in a child process of its own) and
compares, entry by entry, what ptxas reports for it: its stack frame and
spill bytes, and its registers, barriers, stack size, shared and
constant memory. Prints the entries whose report differs, those only one
checkout has, and a summary line; exits 1 where an entry of the parent
changed. A change that adds kernel instances and leaves the parent's
alone shows only new entries. Needs nvcc (the card's machine).
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ENTRY = re.compile(r"Compiling entry function '([^']+)'")
PROPS = re.compile(r"Function properties for (\S+)")
FRAME = re.compile(r"\d+ bytes stack frame.*")
USED = re.compile(r"Used \d+ registers.*")


def reports(root: Path) -> dict:
    """entry -> (source, its stack frame and spill line, its registers
    line) of the checkout at root as ptxas wrote them, building its
    libraries first."""
    code = ("from drt_tpu_torch.utils import native; "
            "built = native.build_all(); "
            "print('\\n'.join(str(native.log_path(s)) for s in built))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True).stdout
    got = {}
    for log in out.split():
        entry, props, frame = None, None, None
        for line in Path(log).read_text().splitlines():
            m = ENTRY.search(line)
            if m:
                entry, props, frame = m.group(1), None, None
                continue
            m = PROPS.search(line)
            if m:
                props = m.group(1).rstrip(":")
            m = FRAME.search(line)
            if m and props == entry:
                frame = m.group(0).strip()
            m = USED.search(line)
            if m and entry is not None:
                got[entry] = (Path(log).stem, frame, m.group(0).strip())
                entry = None
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    args = ap.parse_args()
    parent, change = reports(args.parent.resolve()), reports(args.root)
    changed = 0
    for entry in sorted(parent):
        if entry not in change:
            print(f"[ptxas] only in the parent: {parent[entry]} {entry}")
            changed += 1
        elif change[entry] != parent[entry]:
            print(f"[ptxas] changed: {parent[entry]} -> {change[entry]} "
                  f"{entry}")
            changed += 1
    new = sorted(set(change) - set(parent))
    for entry in new:
        print(f"[ptxas] new: {change[entry]} {entry}")
    print(f"[ptxas] {len(parent)} parent entries, {changed} changed or "
          f"gone, {len(new)} new")
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main())
