#!/usr/bin/env python3
"""Issue floors of the elementwise dropout kernels (F, G, H, H′ and E in
``gavit_tpu_torch/csrc/dropout.cu``), from the instructions their SASS gives
a thread for each element.

``cuobjdump -sass`` lists the built library's code. For each kernel the
count is one pass of its outermost loop, read the way a thread with a whole
unit and nothing left over runs it: straight on at a conditional forward
branch (the ragged tail and the out-of-range guards branch away from that
path), along an unconditional one, up to the loop's back edge. A kernel
whose grid gives each thread one pass (G and E; every kernel of the layout
before the persistent walk) also pays the code before the loop, and that is
added. Divided by the elements of one pass, that is the instructions an
element; the floor is those instructions / 32 over the card's
sub-partitions (4 an SM), one warp instruction a clock each at the highest
SM clock (``nvidia-smi``'s clocks.max.sm):

    python3 tools/sass_issue.py [LIBRARY.so]

With no argument it reads this tree's library (``_build.library_path()``,
built first if it is missing; building needs ``nvcc``). It recognises both
layouts by name: the persistent walk (``keep_mask_kernel`` present) and the
one-vector-a-thread kernels that came before it.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
# the main path's shapes: 384-px hidden rows (H, H′), one [128, 197, 768]
# site (F, G), the b128 MLP rows' two masks (E)
ELEMENTS = {"F": 128 * 197 * 768, "G": 128 * 197 * 768, "H": 16 * 577 * 3072,
            "H′": 16 * 577 * 3072, "E": 25216 * (3072 + 768)}
# op index of elementwise_kernel<op, T> for each kernel
_OPS = {"F": 0, "H": 1, "H′": 2, "G": 3}
# the persistent walk's elements a pass (units a step x 8 bf16 or 4 fp32),
# and whether a thread runs one pass; the layout before it took 8 elements
# a thread, one pass
_WALK = {"F": (8, False), "H": (16, False), "H′": (16, False),
         "G": (8, True), "E": (4, True)}

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")


def functions(lib: Path) -> dict[str, list[tuple[int, str]]]:
    """Mangled kernel name → its (address, instruction) pairs, NOPs left out."""
    out = subprocess.run([CUOBJDUMP, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and cur is not None and not m.group(2).strip().startswith("NOP"):
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def _target(text: str) -> int | None:
    m = re.match(r"(@!?U?PT?\d*\s+)?BRA(\.\w+)*\s+(`\()?0x([0-9a-f]+)", text)
    return int(m.group(4), 16) if m else None


def one_pass(code: list[tuple[int, str]]) -> tuple[int, int]:
    """(instructions of one pass of the outermost loop, instructions before
    it), read straight on at conditional forward branches."""
    index = {a: i for i, (a, _) in enumerate(code)}
    back = [(t, a) for a, text in code
            if (t := _target(text)) is not None and t <= a and t in index]
    head, edge = min(back)
    count, i, seen = 0, index[head], set()
    while i < len(code) and i not in seen:
        seen.add(i)
        addr, text = code[i]
        count += 1
        t = _target(text)
        if addr == edge or text.startswith("EXIT"):
            break
        if t is not None and not text.startswith("@"):
            if t > edge:
                break
            i = index[t]
            continue
        i += 1
    return count, index[head]


def per_element(lib: Path) -> dict[str, tuple[float, str]]:
    """Kernel → (instructions an element, how it was counted) for the bf16
    F, G, H, H′ and the fp32 E."""
    funcs = functions(lib)
    walk = any("keep_mask_kernel" in name for name in funcs)

    def find(pattern):
        return next(code for name, code in funcs.items()
                    if re.search(pattern, name))

    out = {}
    for key in ("F", "G", "H", "H′", "E"):
        if key == "E":
            pattern = "keep_mask_kernel" if walk else r"elementwise_kernelILi4EfE"
        else:
            pattern = rf"elementwise_kernelILi{_OPS[key]}E13__nv_bfloat16E"
        elements, one_shot = _WALK[key] if walk else (8, True)
        code = find(pattern)
        body, before = one_pass(code)
        total = body + before if one_shot else body
        how = (f"{total} a thread for {elements} elements (one pass and the "
               f"code before it)" if one_shot else
               f"{body} a pass of the persistent loop for {elements} elements")
        if key in ("H", "H′"):
            # GELU′'s density term x·e·(1/sqrt(2π)): H must not compute it
            dg = sum("0.3989" in text for _, text in code)
            how += f"; {dg} instructions take GELU′'s 1/sqrt(2π)"
        out[key] = (total / elements, how)
    return out


def issue_floor_ms(instructions: float, elements: int) -> float:
    """Least time, in ms, for ``elements`` at ``instructions`` each: warp
    instructions over 4 sub-partitions an SM at the highest SM clock."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    hz = float(smi.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return instructions * elements / 32 / (4 * sms * hz) * 1e3


def report(lib: Path) -> list[str]:
    """One line a kernel: its instructions an element and its issue floor at
    the main path's shape."""
    return [f"{key}: {per:.2f} instructions an element ({how}); issue floor "
            f"at {ELEMENTS[key]} elements "
            f"{issue_floor_ms(per, ELEMENTS[key]):.4f} ms"
            for key, (per, how) in per_element(lib).items()]


def main() -> int:
    if len(sys.argv) > 1:
        lib = Path(sys.argv[1])
    else:
        from gavit_tpu_torch.ops import _build

        lib = Path(_build.library()._name)
    for line in report(lib):
        print(f"{line} ({lib.name})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
