#!/usr/bin/env python3
"""A/B of the port's SyncTest kernels on one CUDA card: builds K1
(`csrc/synctest_fused.cu`) and K2 with its verdict (`csrc/synctest_tiled.cu`)
from several source trees, holds every build to the first one's carries bit
for bit, and times each build on the same carries, in turns. Run from the
repository root:

    python3 scripts/kernel_ab.py --tree parent=../parent-checkout \\
        --variant 'parent_no_tail=parent:synctest_fused.cu:  if (!is_last) return;=>  return;' \\
        --cells k1_4096,a1_4096,verdict_t240_d8 --sass

--tree NAME=ROOT   a checkout whose ggrs_tpu_torch/csrc/ is built; this one
                   ("change=.") is always there, after the trees given
--variant NAME=TREE:FILE:OLD=>NEW
                   TREE's sources with the text OLD of FILE replaced by NEW:
                   a build for timing a part of a kernel switched off (it may
                   give other bits, which is printed, not an error)
--cells            the cells to run (default: all of CELLS)
--rounds           timing rounds, each over every build, in turn forward and
                   backward (default 2)
--sass             compare each kernel source's SASS, function by function,
                   between the first two trees (`cuobjdump -sass`, names of
                   anonymous namespaces aside), for every source of
                   kernels/build.py KINDS

Prints the card and power limit, each build's ptxas registers and spills,
then one line a cell: whether each build's carries (or verdict outputs)
equal the first tree's after every batch, and each build's ms per round.
Batches of more than one tick and K2 are timed back to back with CUDA
events; single-tick batches and the verdict queued behind a spin kernel
(chip_smoke.queued_ms), since they are shorter than their Python wrappers.
Imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name: (kernel source, model, players, entities, check distance, ticks a batch)
CELLS = {
    "k1_4096": ("synctest_fused", "ExGame", 2, 4096, 8, 60),
    "k1_65536": ("synctest_fused", "ExGame", 2, 65536, 16, 60),
    "a1_4096": ("synctest_fused", "Arena", 2, 4096, 8, 60),
    "a1_65536": ("synctest_fused", "Arena", 2, 65536, 8, 60),
    "a1_t1": ("synctest_fused", "Arena", 2, 4096, 8, 1),
    "a1_p17": ("synctest_fused", "Arena", 17, 4352, 8, 20),
    "a1_p32": ("synctest_fused", "Arena", 32, 4096, 8, 20),
    "s1_4096": ("synctest_fused", "Swarm", 2, 4096, 8, 60),
    "k1_d1": ("synctest_fused", "ExGame", 2, 4096, 1, 7),
    "a1_d3": ("synctest_fused", "Arena", 4, 4096, 3, 4),
    "k2_1m": ("synctest_tiled", "ExGame", 2, 1 << 20, 8, 240),
    "s2_1m": ("synctest_tiled", "Swarm", 2, 1 << 20, 8, 240),
    "ati_4096": ("synctest_tiled", "Arena", 2, 4096, 8, 60),
    "verdict_t60_d8": ("verdict", "ExGame", 2, 4096, 8, 60),
    "verdict_t60_d16": ("verdict", "ExGame", 2, 4096, 16, 60),
    "verdict_t240_d8": ("verdict", "ExGame", 2, 4096, 8, 240),
    "verdict_t1_d8": ("verdict", "ExGame", 2, 4096, 8, 1),
}
BATCHES, CORRUPT_AT, TIMED = 6, 4, 20  # equality batches, the one after a corrupted slot, timed batches
SPIN_REPS = 200  # queued launches a timing


def build_all(builds, kinds, nvcc_flags, nvcc):
    """Compile every (build, kind) in parallel into a temp dir; returns
    {(build, kind): (library path, ptxas report)}."""
    tmp = Path(tempfile.mkdtemp())
    procs = {}
    for name, (src, patch) in builds.items():
        d = tmp / name
        shutil.copytree(src, d)
        if patch:
            fname, old, new = patch
            text = (d / fname).read_text()
            if old not in text:
                sys.exit(f"kernel_ab: variant {name}: {old!r} is not in {fname}")
            (d / fname).write_text(text.replace(old, new))
        for kind in kinds:
            out = d / f"{kind}.so"
            cmd = [nvcc, *nvcc_flags, "-I", str(d), "-o", str(out), str(d / f"{kind}.cu")]
            procs[(name, kind)] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    done = {}
    for key, (out, proc) in procs.items():
        report = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            sys.exit(f"kernel_ab: nvcc {key} failed:\n{report}")
        done[key] = (out, report)
    return done


def sass(cuobjdump, path):
    """{function: [instruction text]} of a library, addresses and the hash
    of each anonymous namespace (it follows the source's path) left out."""
    text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_", "ANON_", m.group(1))
            funcs[cur] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur:
            funcs[cur].append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)))
    return funcs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA card")
    import chip_smoke
    from ggrs_tpu_torch import Arena, ExGame, Swarm
    from ggrs_tpu_torch.convert import CARRY_KEYS, copy_carry
    from ggrs_tpu_torch.device import sync_test
    from ggrs_tpu_torch.device.fused_core import FusedSyncTestCore
    from ggrs_tpu_torch.device.planes import PlaneContext
    from ggrs_tpu_torch.device.tiled_core import TiledSyncTestCore
    from ggrs_tpu_torch.kernels import build

    trees = {}
    for spec in args.tree + [f"change={ROOT}"]:
        name, root = spec.split("=", 1)
        trees[name] = Path(root).resolve() / "ggrs_tpu_torch" / "csrc"
    builds = {name: (src, None) for name, src in trees.items()}
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        tree, fname, patch = rest.split(":", 2)
        old, new = patch.split("=>", 1)
        builds[name] = (trees[tree], (fname, old.replace("\\n", "\n"), new.replace("\\n", "\n")))
    cells = [c.strip() for c in args.cells.split(",") if c.strip()]
    kinds = sorted({"synctest_tiled" if CELLS[c][0] == "verdict" else CELLS[c][0] for c in cells})
    if args.sass:
        kinds = sorted(set(kinds) | set(build.KINDS))
    libs = build_all(builds, kinds, build.NVCC_FLAGS, build.nvcc())
    print(chip_smoke.card_line())
    for (name, kind), (_, report) in sorted(libs.items()):
        for line in build.ptxas_summary(report):
            print(f"ptxas {name} {kind}: {line}")
    if args.sass:
        first, second = list(trees)[:2]
        cuobjdump = str(Path(build.nvcc()).parent / "cuobjdump")
        for kind in build.KINDS:
            a, b = sass(cuobjdump, libs[(first, kind)][0]), sass(cuobjdump, libs[(second, kind)][0])
            for fn in sorted(set(a) | set(b)):
                same = a.get(fn) == b.get(fn)
                print(f"sass {kind} {fn[:96]}: " + ("same" if same else
                      f"differs ({len(a.get(fn, []))} against {len(b.get(fn, []))} instructions)"))

    dev = torch.device("cuda")
    models = {"ExGame": ExGame, "Arena": Arena, "Swarm": Swarm}
    loaded = {key: ctypes.CDLL(str(path)) for key, (path, _) in libs.items()}
    order = list(builds)
    rng = np.random.default_rng(9)
    for cell in cells:
        kind, model, players, n, d, t_ticks = CELLS[cell]
        lib_kind = "synctest_tiled" if kind == "verdict" else kind
        ctx = PlaneContext(models[model](players, n), players, d, dev)
        mod = {"ExGame": 16, "Arena": 64, "Swarm": 128}[model]
        scripts = [torch.from_numpy(rng.integers(0, mod, size=(t_ticks, players, ctx.input_size)).astype(np.int32))
                   .to(dev) for _ in range(BATCHES)]

        def use(name):
            build._LIBS[lib_kind] = loaded[(name, lib_kind)]
            if kind == "synctest_fused":
                core = FusedSyncTestCore(ctx)
                return core, lambda carry, inputs: core.batch(carry, inputs)
            core = TiledSyncTestCore(ctx)
            return core, lambda carry, inputs: core.run_kernel(carry, inputs)

        if kind == "verdict":  # random parts past frame d: the work of a batch's verdict, whatever the values
            carry = sync_test.initial_carry(ctx)
            carry["meta"][0] = 100
            parts = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(t_ticks, d)).astype(np.int32)).to(dev)
            outs, times = {}, {}
            for name in order:
                core, _ = use(name)
                out = copy_carry(carry)
                core.verdict(out, parts, parts)
                outs[name] = out
            equal = {name: all(torch.equal(outs[name][k], outs[order[0]][k]) for k in ("h_tag", "h_hi", "h_lo", "meta"))
                     for name in order}
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    core, _ = use(name)
                    out = copy_carry(carry)
                    ms = chip_smoke.queued_ms(torch, lambda: core.verdict(out, parts, parts), SPIN_REPS)
                    times.setdefault(name, []).append(round(ms, 5))
        else:
            equal, hist = {}, {}
            for name in order:
                _, run = use(name)
                carry = sync_test.initial_carry(ctx)
                hist[name] = []
                for b, inputs in enumerate(scripts):
                    if b == CORRUPT_AT:  # the slot the next rollback loads
                        carry["ring"][(int(carry["meta"][0]) - d) % ctx.ring_len, 0, :64] += 7
                    run(carry, inputs)
                    torch.cuda.synchronize()
                    hist[name].append(copy_carry(carry))
                equal[name] = all(torch.equal(hist[name][b][k], hist[order[0]][b][k])
                                  for b in range(BATCHES) for k in CARRY_KEYS)
            base = copy_carry(hist[order[0]][CORRUPT_AT - 1])
            _, run = use(order[0])
            while kind == "synctest_fused" and int(base["meta"][0]) <= d:  # time ticks that all roll back
                run(base, scripts[0])
            times = {}
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    _, run = use(name)
                    carry = copy_carry(base)
                    run(carry, scripts[0])
                    torch.cuda.synchronize()
                    if t_ticks > 1 or kind == "synctest_tiled":
                        reps = TIMED if n <= 65536 else 3
                        ms = chip_smoke.events_ms(torch, lambda: run(carry, scripts[0]), reps)
                    else:
                        ms = chip_smoke.queued_ms(torch, lambda: run(carry, scripts[0]), SPIN_REPS)
                    times.setdefault(name, []).append(round(ms, 4))
        same = ", ".join(f"{name} {'==' if equal[name] else '!='} {order[0]}" for name in order[1:])
        print(f"{cell}: {same}; ms {json.dumps(times)}", flush=True)


if __name__ == "__main__":
    main()
