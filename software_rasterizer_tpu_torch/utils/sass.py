"""The triangle loop of a kernel in its SASS: instructions a row; or its
box loop: instructions a box test.

    python -m software_rasterizer_tpu_torch.utils.sass [--csrc DIR] [--rays N] [--boxes | --entry-bytes B] SOURCE KERNEL [SOURCE KERNEL ...]

builds each CUDA source of DIR (default: the package's csrc/) with the
package's nvcc flags and prints, for the kernel whose mangled name
contains KERNEL, its triangle loop's instructions a row (one row of the
table tested against N rays: the shadow ray and the bounce ray in the
path kernels, the default; one ray in the Whitted kernel) and their mix.
`chip_smoke.py` calls `row_loop` on the libraries it built, to turn the
count into an issue floor: instructions x rows x lane-iterations over
(SMs x 4 schedulers x 32 lanes x clock).

The triangle loop is the innermost loop (a backward branch and the code
it jumps over) that holds Moller-Trumbore's reciprocals (a MUFU.RCP a
ray and row) and no other MUFU function: the sphere loop holds square roots, the
sampling code logarithms and sines. The count is static: every
instruction of the loop body, a conditional block included, once. It
needs the CUDA toolkit's cuobjdump; only the machine with the card has it.
For the two-stage test of kernels #2, #4, #6, #7 and #8 it also counts
the instructions a warp skips when its stage-1 vote fails (`--rays 2` for
trace_nearest_kernel, 1 for trace_listed_stream_kernel,
trace_listed_all_kernel and trace_fused_cull_kernel at blocks of 64 rays,
4 for trace_unculled_kernel at its blocks of 1024 rays).

With `--boxes` it counts the box loop of the cull prepass
(cull_prepass_kernel) instead, which holds no reciprocal: the innermost
loop with a warp vote (VOTE.ANY) and no MUFU instruction, its
instructions a vote (one box tested by every lane's N ray slots) and
their mix, which shows what the slab test's NaN-keeping min / max compile
to.

With `--entry-bytes B` it counts the list walk of a raster tile kernel
(raster_tile_kernel): the innermost loop that reads shared memory and
holds no global access, barrier, vote or MUFU, B bytes of shared memory a
list entry, its instructions a list entry and pixel.
"""

from __future__ import annotations

import argparse
import collections
import os
import pathlib
import re
import subprocess
import sys
import tempfile
from typing import Dict, List, Tuple

from software_rasterizer_tpu_torch.utils import cuda_build

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`\()?0x([0-9a-f]+)")


def cuobjdump_path() -> str:
    return str(pathlib.Path(cuda_build.nvcc_path()).with_name("cuobjdump"))


def kernel_sass(lib: pathlib.Path, kernel: str) -> List[Tuple[int, str]]:
    """(address, instruction) of the one function of `lib` whose mangled
    name contains `kernel`."""
    out = subprocess.run([cuobjdump_path(), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs: Dict[str, List[Tuple[int, str]]] = {}
    name = None
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _INSTR.search(line)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    hits = [f for f in funcs if kernel in f]
    if len(hits) != 1:
        raise ValueError(f"{len(hits)} functions of {lib} match {kernel!r}: {sorted(funcs)}")
    return funcs[hits[0]]


def _opcode(instr: str) -> str:
    words = instr.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def row_loop(sass: List[Tuple[int, str]], rays: int = 2) -> dict:
    """The triangle loop of one function's SASS, a row tested against
    `rays` rays (one MUFU.RCP each: two in the path kernels, one in the
    Whitted kernel): "per_row" (instructions a row, NOPs left out),
    "unroll" (rows an iteration), "span" (the loop's instructions), "mix"
    (instructions a row by opcode, without its modifiers) and "skip" (the
    instructions a row that a warp vote jumps over when no lane passes: the
    forward branch on a VOTE.ANY's predicate inside the loop, over the
    second stage of the two-stage test; 0 where the loop has none)."""
    loops = []
    for k, (addr, instr) in enumerate(sass):
        if _opcode(instr).split(".")[0] != "BRA":
            continue
        m = _BRA.search(instr)
        if m is None or int(m.group(1), 16) > addr:
            continue
        target = int(m.group(1), 16)
        body = [(a, i) for a, i in sass[:k + 1] if a >= target and _opcode(i) != "NOP"]
        ops = [_opcode(i) for _, i in body]
        n_rcp = ops.count("MUFU.RCP")
        if n_rcp >= rays and n_rcp % rays == 0 and all(
                not o.startswith("MUFU") or o == "MUFU.RCP" for o in ops):
            loops.append((len(body), n_rcp, ops, body))
    if not loops:
        raise ValueError("no loop with Moller-Trumbore's reciprocals alone")
    span, n_rcp, ops, body = min(loops, key=lambda x: x[:2])
    unroll = n_rcp // rays
    mix = collections.Counter(o.split(".")[0] for o in ops)
    return {"per_row": span / unroll, "unroll": unroll, "span": span,
            "mix": {o: c / unroll for o, c in mix.most_common()},
            "skip": _vote_skip(body) / unroll}


def box_loop(sass: List[Tuple[int, str]], rays: int = 1) -> dict:
    """The box loop of one function's SASS: the innermost loop (a backward
    branch and the code it jumps over) that holds a warp vote (VOTE.ANY)
    and no MUFU instruction, one vote a box, each lane testing `rays` ray
    slots against the box. "per_vote" (instructions a warp vote on one
    box, NOPs left out), "per_box_and_ray" (per_vote / rays), "votes"
    (votes an iteration), "span" (the loop's instructions) and "mix"
    (instructions a vote by opcode, with its first modifier: FMNMX.NAN
    apart from FMNMX)."""
    loops = []
    for k, (addr, instr) in enumerate(sass):
        if _opcode(instr).split(".")[0] != "BRA":
            continue
        m = _BRA.search(instr)
        if m is None or int(m.group(1), 16) > addr:
            continue
        target = int(m.group(1), 16)
        body = [(a, i) for a, i in sass[:k + 1] if a >= target and _opcode(i) != "NOP"]
        ops = [_opcode(i) for _, i in body]
        votes = sum(1 for o in ops if o.startswith("VOTE.ANY"))
        if votes and not any(o.startswith("MUFU") for o in ops):
            loops.append((len(body), votes, ops))
    if not loops:
        raise ValueError("no loop with a warp vote and no MUFU")
    span, votes, ops = min(loops, key=lambda x: x[:2])
    mix = collections.Counter(".".join(o.split(".")[:2]) if o.startswith("FMNMX") else
                              o.split(".")[0] for o in ops)
    return {"per_vote": span / votes, "per_box_and_ray": span / votes / rays,
            "votes": votes, "span": span,
            "mix": {o: c / votes for o, c in mix.most_common()}}


def walk_loop(sass: List[Tuple[int, str]], entry_bytes: int) -> dict:
    """The list walk of a raster tile kernel in one function's SASS: the
    innermost loop (a backward branch and the code it jumps over) that
    reads shared memory (LDS) and holds no global load or store, barrier,
    warp vote or MUFU instruction. Each list entry reads `entry_bytes` of
    shared memory, so the loop's LDS bytes give the entries an iteration.
    "per_entry" (instructions a list entry and pixel, NOPs left out),
    "unroll" (entries an iteration), "span" (the loop's instructions) and
    "mix" (instructions an entry by opcode, without its modifiers)."""
    width = {"64": 8, "128": 16, "U8": 1, "S8": 1, "U16": 2, "S16": 2}
    banned = ("LDG", "STG", "BAR", "VOTE", "MUFU", "ATOM", "RED")
    loops = []
    for k, (addr, instr) in enumerate(sass):
        if _opcode(instr).split(".")[0] != "BRA":
            continue
        m = _BRA.search(instr)
        if m is None or int(m.group(1), 16) > addr:
            continue
        target = int(m.group(1), 16)
        body = [(a, i) for a, i in sass[:k + 1] if a >= target and _opcode(i) != "NOP"]
        ops = [_opcode(i) for _, i in body]
        lds = [o for o in ops if o.split(".")[0] == "LDS"]
        if not lds or any(o.split(".")[0] in banned for o in ops):
            continue
        n_bytes = sum(max([width.get(p, 4) for p in o.split(".")[1:]] or [4]) for o in lds)
        if n_bytes % entry_bytes == 0:
            loops.append((len(body), n_bytes // entry_bytes, ops))
    if not loops:
        raise ValueError(f"no shared-memory loop of whole {entry_bytes}-byte entries")
    span, unroll, ops = min(loops, key=lambda x: x[0] / x[1])
    mix = collections.Counter(o.split(".")[0] for o in ops)
    return {"per_entry": span / unroll, "unroll": unroll, "span": span,
            "mix": {o: c / unroll for o, c in mix.most_common()}}


def _vote_skip(body: List[Tuple[int, str]]) -> int:
    """Instructions of a loop body that a failed warp vote jumps over: for
    each VOTE.ANY, the first later branch taken when its predicate is false
    (`@!P<vote's predicate> BRA`), forward to a target inside the body,
    skips the instructions between the two."""
    end = body[-1][0]
    skip = 0
    for k, (_, instr) in enumerate(body):
        if not _opcode(instr).startswith("VOTE.ANY"):
            continue
        pred = [w.strip(",") for w in instr.split()[1:]][-2]
        for a, i in body[k + 1:]:
            m = _BRA.search(i)
            if i.startswith(f"@!{pred} ") and _opcode(i).split(".")[0] == "BRA" and m:
                target = int(m.group(1), 16)
                if a < target <= end:
                    skip += sum(1 for b, _ in body if a < b < target)
                break
    return skip


def build(source: pathlib.Path, out_dir: pathlib.Path) -> pathlib.Path:
    """`source` built as the package builds its libraries."""
    out = out_dir / (source.stem + ".so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True, capture_output=True, text=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=pathlib.Path, default=cuda_build.CSRC_DIR)
    ap.add_argument("--rays", type=int, default=2,
                    help="rays a row of the loop: 2 in the path kernels, 1 in whitted_uber.cu; "
                    "with --boxes, ray slots a thread")
    ap.add_argument("--boxes", action="store_true",
                    help="count the box loop of a cull prepass (no reciprocal) instead")
    ap.add_argument("--entry-bytes", type=int, default=0,
                    help="count the list walk of a raster tile kernel instead, B bytes of "
                    "shared memory a list entry")
    ap.add_argument("pairs", nargs="+", metavar="SOURCE KERNEL")
    args = ap.parse_args(argv)
    if len(args.pairs) % 2:
        ap.error("give SOURCE KERNEL pairs")
    with tempfile.TemporaryDirectory() as tmp:
        for src, kernel in zip(args.pairs[::2], args.pairs[1::2]):
            lib = build(args.csrc / src, pathlib.Path(tmp))
            if args.entry_bytes:
                loop = walk_loop(kernel_sass(lib, kernel), args.entry_bytes)
                mix = ", ".join(f"{o} {c:g}" for o, c in loop["mix"].items())
                print(f"{os.path.join(str(args.csrc), src)} {kernel}: "
                      f"{loop['per_entry']:g} instructions a list entry and pixel (loop of "
                      f"{loop['span']}, {loop['unroll']} entries an iteration): {mix}",
                      flush=True)
                continue
            if args.boxes:
                loop = box_loop(kernel_sass(lib, kernel), args.rays)
                mix = ", ".join(f"{o} {c:g}" for o, c in loop["mix"].items())
                print(f"{os.path.join(str(args.csrc), src)} {kernel}: "
                      f"{loop['per_box_and_ray']:g} instructions a box and ray slot (loop of "
                      f"{loop['span']}, {loop['votes']} votes an iteration): {mix}", flush=True)
                continue
            loop = row_loop(kernel_sass(lib, kernel), args.rays)
            mix = ", ".join(f"{o} {c:g}" for o, c in loop["mix"].items())
            print(f"{os.path.join(str(args.csrc), src)} {kernel}: {loop['per_row']:g} "
                  f"instructions a row (loop of {loop['span']}, {loop['unroll']} rows an "
                  f"iteration, {loop['skip']:g} a row skipped by a failed warp vote): "
                  f"{mix}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
