"""What the ablate_* tools share: variants of a checkout's kernels, built
at once and timed in turns.

A variant is the checkout's drt_tpu_torch copied (its builds left out)
into drt_tpu_torch/_build/<tool>/<variant>/ with text edits of its CUDA
sources, and built there. Its outputs are wrong by design: it is timed,
never checked. The tools time the variants forward and backward (A B ...
B A), each in a process of its own, so that the card's drift shows.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


def variant_root(root: Path, tool: str, name: str) -> Path:
    slug = re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
    return root / "drt_tpu_torch" / "_build" / tool / slug


def make_variant(root: Path, tool: str, name: str, edits: dict) -> Path:
    """A copy of root's drt_tpu_torch with the variant's edits {source in
    csrc/: [(old, new) or (old, new, anchor), ...]}: old is in the source
    once, or, with an anchor, replaced at its first match after the
    anchor's first match."""
    dst = variant_root(root, tool, name)
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(root / "drt_tpu_torch", dst / "drt_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for source, pairs in edits.items():
        path = dst / "drt_tpu_torch" / "csrc" / source
        text = path.read_text()
        for old, new, *anchor in pairs:
            at = text.find(old, text.index(anchor[0]) if anchor else 0)
            if at < 0 or (not anchor and text.count(old) != 1):
                raise SystemExit(f"variant {name!r}: the text to edit is not "
                                 f"in {path} once: {old!r}")
            text = text[:at] + new + text[at + len(old):]
        path.write_text(text)
    return dst


def build_variants(roots, sources) -> bool:
    """Build `sources` of every variant under `roots`, all at once."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from drt_tpu_torch.utils import native; "
         "[native.build(s) for s in sys.argv[2:]]", str(r), *sources])
        for r in roots]
    return all(p.wait() == 0 for p in procs)


def card(tool: str, label: str) -> bool:
    """Print the "card" line (nvidia-smi's name and power limit); False,
    with a note, where no CUDA device is visible."""
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device visible", file=sys.stderr)
        return False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"kind": "card", "label": label, "smi": smi}),
          flush=True)
    return True


def in_turns(names) -> list:
    """A B ... B A."""
    return list(names) + list(reversed(list(names)))


def run_child(script: str, root: Path, *args: str):
    """Run `script --child root args...` in a process of its own; its
    CompletedProcess, or None (its errors printed) where it failed."""
    res = subprocess.run([sys.executable, script, "--child", str(root),
                          *args], capture_output=True, text=True)
    if res.returncode != 0:
        print(res.stderr[-4000:], file=sys.stderr)
        return None
    return res


def occupancy(native, root: Path, source: str, kernels: dict) -> dict:
    """Resident blocks per SM by the occupancy API of the kernels of
    root's csrc/<source>: kernels maps a name to (the kernel as a C++
    expression, e.g. "regen_sweep_kernel<8>", its dynamic shared memory
    in bytes). Built as a scratch library that includes the source, so
    that a checkout without a query of its own can be asked too. With
    "sms", the card's SM count."""
    import ctypes

    csrc = root / "drt_tpu_torch" / "csrc"
    out_dir = root / "drt_tpu_torch" / "_build" / "occupancy"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(source).stem
    cases = "".join(
        f"    case {k}: f = (const void*){expr}; break;\n"
        for k, (expr, _) in enumerate(kernels.values()))
    src = out_dir / f"{stem}_occupancy.cu"
    src.write_text(
        f'#include "{csrc / source}"\n'
        'extern "C" int drt_occupancy(int k, int bytes, int* per_sm,\n'
        '                             int* sms) {\n'
        '  const void* f = nullptr;\n'
        '  switch (k) {\n' + cases +
        '    default: return -1;\n'
        '  }\n'
        '  cudaError_t e = cudaDeviceGetAttribute(\n'
        '      sms, cudaDevAttrMultiProcessorCount, 0);\n'
        '  if (e == cudaSuccess)\n'
        '    e = cudaFuncSetAttribute(\n'
        '        f, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);\n'
        '  if (e == cudaSuccess)\n'
        '    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n'
        '        per_sm, f, DRT_BLOCK, bytes);\n'
        '  return (int)e;\n'
        '}\n')
    lib_path = out_dir / f"{stem}_occupancy.so"
    subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    out = {}
    for k, (name, (_, n_bytes)) in enumerate(kernels.items()):
        per_sm, sms = ctypes.c_int(), ctypes.c_int()
        rc = lib.drt_occupancy(k, n_bytes, ctypes.byref(per_sm),
                               ctypes.byref(sms))
        if rc:
            raise RuntimeError(f"occupancy query of {name} failed: {rc}")
        out[name] = per_sm.value
        out["sms"] = sms.value
    return out
