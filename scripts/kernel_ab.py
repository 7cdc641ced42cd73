#!/usr/bin/env python3
"""A/B of the port's kernels on one CUDA card: builds K1
(`csrc/synctest_fused.cu`), K2 with its verdict (`csrc/synctest_tiled.cu`),
K3 (`csrc/resim_tick.cu`) and K4 (`csrc/beam_rollout.cu`) from several
source trees, holds every build to the first one's outputs bit for bit,
and times each build on the same inputs, in turns. Run from the repository
root:

    python3 scripts/kernel_ab.py --tree parent=../parent-checkout \\
        --variant 'parent_no_tail=parent:synctest_fused.cu:  if (!is_last) return;=>  return;' \\
        --cells k1_4096,ar2_4096_t1,ab16_4096 --sass

--tree NAME=ROOT   a checkout whose ggrs_tpu_torch/ package is built and
                   driven through its own wrappers; this one ("change=.")
                   is always there, after the trees given
--variant NAME=TREE:FILE:OLD=>NEW
                   TREE's package with the text OLD of csrc/FILE (or of FILE
                   in the package when it names a directory, as
                   device/beam_core.py) replaced (every occurrence) by NEW:
                   a build for timing a part of a kernel switched off (it
                   may give other bits, which is printed, not an error) or
                   another layout
--cells            the cells to run (default: all of CELLS)
--rounds           timing rounds, each over every build, in turn forward and
                   backward (default 2)
--sass             compare each kernel source's SASS, function by function,
                   between the first two trees (`cuobjdump -sass`, names of
                   anonymous namespaces aside), for every source of
                   kernels/build.py KINDS

Each build is a copy of its tree's package, imported under a name of its
own, so a tree whose wrappers or C interfaces differ from this one's is
driven as it is. Prints the card and power limit, each build's ptxas
registers and spills, then one line a cell: whether each build's outputs
equal the first tree's after every launch (K1/K2: the full carry after
every batch, a corrupted slot included; K3: his/los and the whole core
after every dispatch, a corrupted slot included; K4: the trajectory, its
checksums and the anchor's, a killed or corrupted anchor included; the
verdict: history and meta; the injection route: the full carry after every
batch, a killed slot included), and each build's ms per round. Batches of more
than one tick and K2 are timed back to back with CUDA events; single-tick
batches, K3 dispatches, K4 launches and the verdict queued behind a spin
kernel (chip_smoke.queued_ms), since they are shorter than their Python
wrappers. The injection route's tick is the difference of two batches
queued the same way, of 1 + ROUTE_TICKS ticks and of 1, over ROUTE_TICKS:
its device time whatever operations a tree's route runs a tick; a tree
whose route still runs K2, the verdict and the next table as separate
operations (K5's frontier row and a roll) also has each of them timed
alone. Imports no jax.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# K1, K2 and the verdict: (kernel source, model, players, entities, check distance, ticks a batch)
# K3: ("resim_tick", model, players, entities, max_prediction, rows a dispatch); the rows are
#     SyncTest ticks at check distance 8 (load frame c-8, 9 advances, 9 saves), as bench.py:1275's
# K4: ("beam_rollout", model, players, entities, members, steps), from a ring slot of a primed core
# the injection route: ("injected", model, players, entities, check distance, ticks a batch), a whole
#     route tick (K2 on the table, its verdict and the next table) from a carry past frame d
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
    "r2_4096_t1": ("resim_tick", "ExGame", 2, 4096, 9, 1),
    "r2_4096_t8": ("resim_tick", "ExGame", 2, 4096, 9, 8),
    "r2_1m_t1": ("resim_tick", "ExGame", 2, 1 << 20, 9, 1),
    "r2_1m_t8": ("resim_tick", "ExGame", 2, 1 << 20, 9, 8),
    "sr2_4096_t1": ("resim_tick", "Swarm", 2, 4096, 9, 1),
    "sr2_4096_t8": ("resim_tick", "Swarm", 2, 4096, 9, 8),
    "ar2_4096_t1": ("resim_tick", "Arena", 2, 4096, 9, 1),
    "ar2_4096_t8": ("resim_tick", "Arena", 2, 4096, 9, 8),
    "ar2_65536_t1": ("resim_tick", "Arena", 2, 65536, 9, 1),
    "ar2_65536_t8": ("resim_tick", "Arena", 2, 65536, 9, 8),
    "ar4_l16": ("resim_tick", "Arena", 4, 4096, 9, 16),
    "b16_4096": ("beam_rollout", "ExGame", 2, 4096, 16, 11),
    "b12_65536": ("beam_rollout", "ExGame", 2, 65536, 12, 11),
    "sb16_4096": ("beam_rollout", "Swarm", 2, 4096, 16, 11),
    "ab16_4096": ("beam_rollout", "Arena", 2, 4096, 16, 11),
    "ab16_65536": ("beam_rollout", "Arena", 2, 65536, 16, 11),
    "ai_4096": ("injected", "Arena", 2, 4096, 8, 30),
    "ai_65536": ("injected", "Arena", 2, 65536, 8, 30),
}
BATCHES, CORRUPT_AT, TIMED = 6, 4, 20  # equality batches, the one after a corrupted slot, timed batches
SPIN_REPS = 200  # queued launches a timing
# the injection route: extra ticks a timed batch, and batches a timing (a route of 5 operations a
# tick fills the card's launch queue past ~4 batches, and the host then waits behind the spin)
ROUTE_TICKS, ROUTE_REPS = 30, 3
ROUTE_SPIN = 40_000_000  # spin cycles queued a route batch (~20 ms: several times its host enqueue time)
MODS = {"ExGame": 16, "Arena": 64, "Swarm": 128}  # inputs below these
PROBE_PLANE = {"ExGame": 4, "Arena": 4, "Swarm": 0}  # rot, hp, px: a plane the step never clamps back


def import_copy(name, tree, patch, tmp):
    """TREE's ggrs_tpu_torch package copied under tmp/NAME (its build
    directory left out), csrc/FILE patched, imported as kab_NAME."""
    dst = tmp / name / "ggrs_tpu_torch"
    shutil.copytree(tree / "ggrs_tpu_torch", dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if patch:
        fname, old, new = patch
        path = dst / fname if "/" in fname else dst / "csrc" / fname
        text = path.read_text()
        if old not in text:
            sys.exit(f"kernel_ab: variant {name}: {old!r} is not in {fname}")
        path.write_text(text.replace(old, new))
    modname = f"kab_{name}"
    spec = importlib.util.spec_from_file_location(modname, dst / "__init__.py", submodule_search_locations=[str(dst)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[modname] = pkg
    spec.loader.exec_module(pkg)
    importlib.import_module(f"{modname}.kernels.build")
    return pkg


def build_all(pkgs, kinds):
    """Compile every (build, kind of kinds[build]) in parallel to where that
    build's package loads it from; returns {(build, kind): (library, ptxas
    report)}."""
    procs = {}
    for name, pkg in pkgs.items():
        b = pkg.kernels.build
        b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for kind in kinds[name]:
            out = b.library_path(kind)
            cmd = [b.nvcc(), *b.NVCC_FLAGS, "-I", str(b.CSRC), "-o", str(out), str(b.CSRC / f"{kind}.cu")]
            procs[(name, kind)] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    done = {}
    for key, (out, proc) in procs.items():
        report = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            sys.exit(f"kernel_ab: nvcc {key} failed:\n{report}")
        out.with_suffix(".so.log").write_text(report)
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


def synctest_rows(np, core, n_rows, frame, seed, mod):
    """`n_rows` SyncTest ticks at check distance 8 from frame `frame`: each
    loads frame c - 8 and advances 9 frames with 9 saves; the inputs of a
    frame are the same in every row that steps it (as a SyncTest replay's
    are), so the device-verify history latches only what a probe plants."""
    W, P, I = core.window, core.num_players, core.game.input_size
    rng = np.random.default_rng(seed)
    table = rng.integers(0, mod, size=(frame + n_rows + W, P, I), dtype=np.uint8)
    if core.ctx.reduce_len and I == 2:
        table[..., 1] &= 15
    rows = []
    for k in range(n_rows):
        c = frame + k
        start = c - 8
        inputs = np.zeros((W, P, I), np.uint8)
        inputs[:9] = table[start : start + 9]
        slots = np.full((W,), core.scratch_slot, np.int32)
        slots[:9] = (start + np.arange(9)) % core.ring_len
        rows.append(core.pack_tick_row(True, start % core.ring_len, inputs, np.zeros((W, P), np.int32), slots, 9,
                                       start_frame=start))
    return np.stack(rows)


def spin_up_rows(np, core, frames, seed, mod):
    """One-advance rows that save every frame 0..frames-1: what a session
    runs before its first rollback."""
    W, P, I = core.window, core.num_players, core.game.input_size
    rng = np.random.default_rng(seed)
    table = rng.integers(0, mod, size=(frames, P, I), dtype=np.uint8)
    rows = []
    for f in range(frames):
        inputs = np.zeros((W, P, I), np.uint8)
        inputs[0] = table[f]
        slots = np.full((W,), core.scratch_slot, np.int32)
        slots[0] = f % core.ring_len
        rows.append(core.pack_tick_row(False, 0, inputs, np.zeros((W, P), np.int32), slots, 1, start_frame=f))
    return np.stack(rows)


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

    trees = {}
    for spec in args.tree + [f"change={ROOT}"]:
        name, root = spec.split("=", 1)
        trees[name] = Path(root).resolve()
    builds = {name: (root, None) for name, root in trees.items()}
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        tree, fname, patch = rest.split(":", 2)
        old, new = patch.split("=>", 1)
        builds[name] = (trees[tree], (fname, old.replace("\\n", "\n"), new.replace("\\n", "\n")))
    cells = [c.strip() for c in args.cells.split(",") if c.strip()]
    source = {"verdict": ("synctest_tiled",), "injected": ("synctest_tiled", "reduce_table")}
    kinds = sorted({k for c in cells for k in source.get(CELLS[c][0], (CELLS[c][0],))})
    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab_"))
    pkgs = {name: import_copy(name, root, patch, tmp) for name, (root, patch) in builds.items()}
    first = next(iter(pkgs.values()))
    sass_trees = list(trees)[:2] if args.sass else []  # every source of these two, for the SASS
    libs = build_all(pkgs, {name: sorted(set(kinds) | (set(first.kernels.build.KINDS) if name in sass_trees else set()))
                            for name in pkgs})
    print(chip_smoke.card_line())
    for (name, kind), (_, report) in sorted(libs.items()):
        for line in first.kernels.build.ptxas_summary(report):
            print(f"ptxas {name} {kind}: {line}")
    if args.sass:
        a_name, b_name = sass_trees
        cuobjdump = str(Path(first.kernels.build.nvcc()).parent / "cuobjdump")
        for kind in first.kernels.build.KINDS:
            a, b = sass(cuobjdump, libs[(a_name, kind)][0]), sass(cuobjdump, libs[(b_name, kind)][0])
            for fn in sorted(set(a) | set(b)):
                same = a.get(fn) == b.get(fn)
                print(f"sass {kind} {fn[:96]}: " + ("same" if same else
                      f"differs ({len(a.get(fn, []))} against {len(b.get(fn, []))} instructions)"))

    dev = torch.device("cuda")
    order = list(pkgs)
    for cell in cells:
        kind = CELLS[cell][0]
        run = {"resim_tick": tick_cell, "beam_rollout": beam_cell, "injected": injected_cell}.get(kind, synctest_cell)
        equal, times = run(torch, np, dev, pkgs, order, cell, args.rounds, chip_smoke)
        same = ", ".join(f"{name} {'==' if equal[name] else '!='} {order[0]}" for name in order[1:])
        print(f"{cell}: {same}; ms {json.dumps(times)}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)


def in_turns(order, rounds):
    """Each round over every build, forward then backward."""
    for r in range(rounds):
        yield from (order if r % 2 == 0 else order[::-1])


def synctest_cell(torch, np, dev, pkgs, order, cell, rounds, cs):
    """K1, K2 or the verdict: full carries after every batch, then timing."""
    kind, model, players, n, d, t_ticks = CELLS[cell]
    rng = np.random.default_rng(9)
    input_size = getattr(pkgs[order[0]], model)(players, n).input_size
    scripts = [torch.from_numpy(rng.integers(0, MODS[model], size=(t_ticks, players, input_size)).astype(np.int32))
               .to(dev) for _ in range(BATCHES)]

    def use(name):
        pkg = pkgs[name]
        ctx = pkg.device.planes.PlaneContext(getattr(pkg, model)(players, n), players, d, dev)
        if kind == "synctest_fused":
            core = pkg.device.fused_core.FusedSyncTestCore(ctx)
            return pkg, ctx, core, lambda carry, inputs: core.batch(carry, inputs)
        core = pkg.device.tiled_core.TiledSyncTestCore(ctx)
        return pkg, ctx, core, lambda carry, inputs: core.run_kernel(carry, inputs)

    times = {}
    if kind == "verdict":  # random parts past frame d: the work of a batch's verdict, whatever the values
        parts = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(t_ticks, d)).astype(np.int32)).to(dev)
        outs = {}
        for name in order:
            pkg, ctx, core, _ = use(name)
            carry = pkg.device.sync_test.initial_carry(ctx)
            carry["meta"][0] = 100
            core.verdict(carry, parts, parts)
            outs[name] = carry
        equal = {name: all(torch.equal(outs[name][k], outs[order[0]][k]) for k in ("h_tag", "h_hi", "h_lo", "meta"))
                 for name in order}
        for name in in_turns(order, rounds):
            pkg, ctx, core, _ = use(name)
            carry = pkg.device.sync_test.initial_carry(ctx)
            carry["meta"][0] = 100
            ms = cs.queued_ms(torch, lambda: core.verdict(carry, parts, parts), SPIN_REPS)
            times.setdefault(name, []).append(round(ms, 5))
        return equal, times

    keys = pkgs[order[0]].convert.CARRY_KEYS
    equal, hist = {}, {}
    for name in order:
        pkg, ctx, _, run = use(name)
        carry = pkg.device.sync_test.initial_carry(ctx)
        hist[name] = []
        for b, inputs in enumerate(scripts):
            if b == CORRUPT_AT:  # the slot the next rollback loads
                carry["ring"][(int(carry["meta"][0]) - d) % ctx.ring_len, 0, :64] += 7
            run(carry, inputs)
            torch.cuda.synchronize()
            hist[name].append({k: carry[k].clone() for k in keys})
        equal[name] = all(torch.equal(hist[name][b][k], hist[order[0]][b][k]) for b in range(BATCHES) for k in keys)
    _, ctx, _, run = use(order[0])
    base = {k: v.clone() for k, v in hist[order[0]][CORRUPT_AT - 1].items()}
    while kind == "synctest_fused" and int(base["meta"][0]) <= d:  # time ticks that all roll back
        run(base, scripts[0])
    for name in in_turns(order, rounds):
        _, _, _, run = use(name)
        carry = {k: v.clone() for k, v in base.items()}
        run(carry, scripts[0])
        torch.cuda.synchronize()
        if t_ticks > 1 or kind == "synctest_tiled":
            reps = TIMED if n <= 65536 else 3
            ms = cs.events_ms(torch, lambda: run(carry, scripts[0]), reps)
        else:
            ms = cs.queued_ms(torch, lambda: run(carry, scripts[0]), SPIN_REPS)
        times.setdefault(name, []).append(round(ms, 4))
    return equal, times


def tick_cell(torch, np, dev, pkgs, order, cell, rounds, cs):
    """K3: each build's core runs the same spin-up and SyncTest dispatches
    (device verification on) from the same initial world; his/los and the
    whole core are held to the first build's after every dispatch, a slot
    corrupted before the dispatch after CORRUPT_AT. Then each build's
    dispatch of the first rows is timed from one core state."""
    _, model, players, n, mp, t_rows = CELLS[cell]
    mod = MODS[model]

    def core_of(name):
        pkg = pkgs[name]
        return pkg, pkg.ResimCore(getattr(pkg, model)(players, n), mp, players, device_verify=True, device=dev)

    _, proto = core_of(order[0])
    warm = spin_up_rows(np, proto, 9, seed=n + players, mod=mod)
    batches = [synctest_rows(np, proto, t_rows, 9 + b * t_rows, seed=b, mod=mod) for b in range(BATCHES)]
    keys = tuple(proto.carry)
    equal, hist, cores = {}, {}, {}
    for name in order:
        _, core = core_of(name)
        if core.ctx.reduce_len:
            core.tick_multi(cs.prime_row(core)[None])
        core.tick_multi(warm)
        hist[name] = []
        for b, rows in enumerate(batches):
            if b == CORRUPT_AT:  # the slot this dispatch's first row loads
                col = core.carry["ring"][int(rows[0][1]), PROBE_PLANE[model], :64]
                col.copy_(col * 0 if core.ctx.reduce_len else col + 7)
            his, los = core.tick_multi(rows)
            torch.cuda.synchronize()
            hist[name].append(({k: core.carry[k].clone() for k in keys}, his.clone(), los.clone()))
        cores[name] = core
        ref = hist[order[0]]
        equal[name] = all(torch.equal(c[k], ref[b][0][k]) for b, (c, _, _) in enumerate(hist[name]) for k in keys) \
            and all(torch.equal(h, ref[b][1]) and torch.equal(lo, ref[b][2])
                    for b, (_, h, lo) in enumerate(hist[name]))
    base = hist[order[0]][CORRUPT_AT - 1][0]
    times = {}
    for name in in_turns(order, rounds):
        core = cores[name]
        for k in keys:
            core.carry[k].copy_(base[k])
        rows = core.upload(batches[CORRUPT_AT])
        core.tick_core.tick_multi(core.carry, rows)
        torch.cuda.synchronize()
        ms = cs.queued_ms(torch, lambda: core.tick_core.tick_multi(core.carry, rows), SPIN_REPS)
        times.setdefault(name, []).append(round(ms, 5))
    return equal, times


def beam_cell(torch, np, dev, pkgs, order, cell, rounds, cs):
    """K4: each build's core is primed by the same rows; speculations from
    several slots, one of them with a killed (arena) or corrupted anchor,
    are held to the first build's field for field; then each build's launch
    from the newest slot is timed."""
    _, model, players, n, B, L = CELLS[cell]
    mod, mp = MODS[model], 9
    rng = np.random.default_rng(n + B)
    specs = []
    for k in range(4):
        inputs = rng.integers(0, mod, size=(B, L, players, 1), dtype=np.uint8)
        statuses = np.where(rng.random((B, L, players)) < 0.1, 2, 0).astype(np.int32)
        specs.append((inputs, statuses))
    equal, outs, cores = {}, {}, {}
    for name in order:
        pkg = pkgs[name]
        core = pkg.ResimCore(getattr(pkg, model)(players, n), mp, players, device=dev)
        rows = [cs.prime_row(core)[None]] if core.ctx.reduce_len else []
        core.tick_multi(np.concatenate(rows + [spin_up_rows(np, core, 9, seed=n, mod=mod),
                                               synctest_rows(np, core, 4, 9, seed=1, mod=mod)]))
        got = []
        for k, (inputs, statuses) in enumerate(specs):
            slot = (3 * k + 1) % core.ring_len
            saved = core.carry["ring"][slot, PROBE_PLANE[model], :64].clone()
            if k == 3:
                core.carry["ring"][slot, PROBE_PLANE[model], :64] = 0 if core.ctx.reduce_len else saved + 7
            spec = core.speculate(slot, inputs, statuses)
            torch.cuda.synchronize()
            got.append([t.clone() for t in spec])
            core.carry["ring"][slot, PROBE_PLANE[model], :64] = saved
        outs[name], cores[name] = got, core
        equal[name] = all(torch.equal(a, b) for g, r in zip(got, outs[order[0]]) for a, b in zip(g, r))
    times = {}
    for name in in_turns(order, rounds):
        core = cores[name]
        br = core.beam_rollout
        slot = int(core.carry["r_frame"][: core.ring_len].argmax())
        script = br.script(*specs[0])
        br.rollout(core.carry["ring"], core.carry["r_frame"], slot, script)
        torch.cuda.synchronize()
        ms = cs.queued_ms(torch, lambda: br.rollout(core.carry["ring"], core.carry["r_frame"], slot, script),
                          SPIN_REPS)
        times.setdefault(name, []).append(round(ms, 5))
    return equal, times


def injected_cell(torch, np, dev, pkgs, order, cell, rounds, cs):
    """The injection route (`InjectedReduceCore.batch`): each build runs the
    same batches from a fresh carry across frame d, 64 entities killed in
    the slot the batch after CORRUPT_AT loads first, its full carry held to
    the first build's after every batch; then each build's route tick is
    timed from one carry past frame d (see the module's docstring), and the
    separate operations of a route that has them."""
    _, model, players, n, d, t_ticks = CELLS[cell]
    rng = np.random.default_rng(n + d)
    scripts = [torch.from_numpy(rng.integers(0, MODS[model], size=(t_ticks, players, 1)).astype(np.int32)).to(dev)
               for _ in range(BATCHES)]

    def use(name):
        pkg = pkgs[name]
        ctx = pkg.device.planes.PlaneContext(getattr(pkg, model)(players, n), players, d, dev)
        return pkg, ctx, pkg.device.injected_core.InjectedReduceCore(ctx)

    keys = pkgs[order[0]].convert.CARRY_KEYS
    equal, hist = {}, {}
    for name in order:
        pkg, ctx, core = use(name)
        carry = pkg.device.sync_test.initial_carry(ctx)
        hist[name] = []
        for b, inputs in enumerate(scripts):
            c = b * t_ticks
            if b == CORRUPT_AT:
                carry["ring"][(c - d) % ctx.ring_len, PROBE_PLANE[model], :64] = 0
            core.batch(carry, inputs, frame=c)
            torch.cuda.synchronize()
            hist[name].append({k: carry[k].clone() for k in keys})
        equal[name] = all(torch.equal(hist[name][b][k], hist[order[0]][b][k]) for b in range(BATCHES) for k in keys)
    base = hist[order[0]][CORRUPT_AT - 1]
    c0 = CORRUPT_AT * t_ticks
    long = torch.cat([scripts[0]] * -(-(1 + ROUTE_TICKS) // t_ticks))[: 1 + ROUTE_TICKS]
    times = {}
    for name in in_turns(order, rounds):
        pkg, ctx, core = use(name)
        carry = {k: v.clone() for k, v in base.items()}
        frame = [c0]

        def batch(inputs):
            core.batch(carry, inputs, frame=frame[0])
            frame[0] += inputs.shape[0]

        batch(long)
        torch.cuda.synchronize()
        one = cs.queued_ms(torch, lambda: batch(long[:1]), ROUTE_REPS, spin=ROUTE_SPIN)
        many = cs.queued_ms(torch, lambda: batch(long), ROUTE_REPS, spin=ROUTE_SPIN)
        got = {"tick": round((many - one) / ROUTE_TICKS, 5), "batch_of_1": round(one, 5)}
        if hasattr(core.tiled, "tick_injected"):  # the one-launch tick alone, every save stored
            red = core.reduce.reduce_sources(carry, frame[0])
            nxt = torch.zeros_like(red)
            got["tick_alone"] = round(cs.queued_ms(
                torch, lambda: core.tiled.tick_injected(carry, long[:1], red, nxt), SPIN_REPS), 5)
        else:  # K2, the verdict and the next table apart
            red = core.reduce.reduce_sources(carry, frame[0])
            parts = core.tiled.run_kernel(carry, long[:1], red_raw=red)
            rolled = torch.empty_like(red)

            def roll():
                out = torch.empty_like(red)
                out[:d] = red[1:]

            ops = {"k2": lambda: core.tiled.run_kernel(carry, long[:1], red_raw=red),
                   "verdict": lambda: core.tiled.verdict(carry, *parts),
                   "k5_frontier": lambda: core.reduce.frontier(carry, out=rolled[d:]),
                   "roll": roll}
            for op, fn in ops.items():
                got[op] = round(cs.queued_ms(torch, fn, SPIN_REPS), 5)
        got["k5_table"] = round(cs.queued_ms(torch, lambda: core.reduce.reduce_sources(carry, frame[0]), SPIN_REPS), 5)
        torch.cuda.synchronize()
        times.setdefault(name, []).append(got)
    return equal, times


if __name__ == "__main__":
    main()
