"""Launch geometries of the port's kernels, side by side on one GPU.

The guidance kernels (``csrc/guidance_fused.cu``, ``csrc/guidance_frozen.cu``)
and the superstep kernel (``csrc/superstep.cu``) fix their block shape by
``#define`` (warps a block, columns a block, blocks an SM, which caps the
registers; output tiles a warp), the clearance kernels
(``csrc/min_clearance.cu``) the candidate rows of a scene a block covers,
the most threads a block, and the nL whose disc-pair loop is a template
instance (0: every nL takes the generic, guarded loop).  This script writes
a copy of each source per candidate geometry with those lines replaced
(into ``build/pstl_tpu_torch/sweep/``), builds all copies at once, holds
every build against the plain version at the main path's shapes
(``kernel_times.main_path_calls``) and times it (``chip_smoke.kernel_ms``),
in turns: every geometry once, then every geometry again in reverse order.
It prints ptxas's registers, spills and stack frame per kernel, a table, and
the card's name and power limit.  The first geometry of each list is the one
the sources ship; nothing selects another at run time.

    python scripts/geometry_sweep.py [--libs min_clearance,superstep]
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

def _mc(rows, threads, nlt):
    return (f"r{rows}t{threads}n{nlt}",
            {"MC_ROWS": rows, "MC_THREADS": threads, "MC_NLT": nlt})


#: per library: (tag, macro values), the shipped geometry first.  w = warps a
#: block, c = columns a block, b = blocks an SM (1: no register cap), n =
#: output tiles a warp accumulates at once; for the clearance kernels r =
#: rows a block, t = most threads a block, n = the templated nL
VARIANTS = {
    "min_clearance": [_mc(64, 640, 4), _mc(32, 640, 4), _mc(16, 320, 4),
                      _mc(8, 160, 4), _mc(64, 1024, 4), _mc(64, 640, 0)],
    "guidance_fused": [
        ("w8c8b3", {"GF_WARPS": 8, "GF_COLS": 8, "GF_MINB": 3}),
        ("w8c8b1", {"GF_WARPS": 8, "GF_COLS": 8, "GF_MINB": 1}),
        ("w8c8b4", {"GF_WARPS": 8, "GF_COLS": 8, "GF_MINB": 4}),
        ("w16c16b1", {"GF_WARPS": 16, "GF_COLS": 16, "GF_MINB": 1}),
        ("w8c16b3", {"GF_WARPS": 8, "GF_COLS": 16, "GF_MINB": 3})],
    "guidance_frozen": [
        ("w8c8b3", {"GZ_WARPS": 8, "GZ_COLS": 8, "GZ_MINB": 3}),
        ("w8c8b1", {"GZ_WARPS": 8, "GZ_COLS": 8, "GZ_MINB": 1})],
    "superstep": [
        ("w16c16n2b2", {"SS_WARPS": 16, "SS_COLS": 16, "SS_NTW": 2,
                        "SS_MINB": 2}),
        ("w16c16n2b1", {"SS_WARPS": 16, "SS_COLS": 16, "SS_NTW": 2,
                        "SS_MINB": 1}),
        ("w16c32n2b1", {"SS_WARPS": 16, "SS_COLS": 32, "SS_NTW": 2,
                        "SS_MINB": 1}),
        ("w8c32n4b1", {"SS_WARPS": 8, "SS_COLS": 32, "SS_NTW": 4,
                       "SS_MINB": 1}),
        ("w32c32n1b1", {"SS_WARPS": 32, "SS_COLS": 32, "SS_NTW": 1,
                        "SS_MINB": 1})],
}


def build_all(root, geometry_macro, variants_of):
    """One nvcc per (library, geometry) of ``variants_of``, all at once:
    (library, tag) -> (path of the .so, ptxas summary)."""
    from pstl_tpu_torch.ops import _build
    procs = []
    for lib, variants in variants_of.items():
        with open(os.path.join(_build.CSRC_DIR, f"{lib}.cu")) as f:
            text = f.read()
        for tag, defs in variants:
            out_dir = os.path.join(root, lib, tag)
            os.makedirs(out_dir, exist_ok=True)
            src, n = re.subn(
                geometry_macro,
                lambda m: f"#define {m.group(1)} {defs[m.group(1)]}", text,
                flags=re.M)
            if n != len(defs):
                sys.exit(f"{lib}.cu: {n} geometry macros, {tag} sets "
                         f"{len(defs)}")
            cu = os.path.join(out_dir, f"{lib}.cu")
            with open(cu, "w") as f:
                f.write(src)
            so = os.path.join(out_dir, f"lib{lib}.so")
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                   _build.CSRC_DIR, "-o", so, cu]
            procs.append((lib, tag, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    built = {}
    for lib, tag, so, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {lib} {tag}:\n{err}")
        built[(lib, tag)] = (so, _build.ptxas_summary(out + err))
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--libs", default=",".join(VARIANTS),
                    help="comma-separated libraries to sweep (default: all)")
    libs = ap.parse_args().libs.split(",")
    if not set(libs) <= set(VARIANTS):
        ap.error(f"--libs must be among {sorted(VARIANTS)}")
    variants_of = {lib: VARIANTS[lib] for lib in libs}

    import torch
    if not torch.cuda.is_available():
        sys.exit("geometry_sweep.py needs a CUDA device")
    import chip_smoke as cs
    from kernel_times import main_path_calls
    from pstl_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    name_power = cs.gpu_name_power()
    print(f"device: {name_power}", flush=True)
    built = build_all(os.path.join(_build.BUILD_ROOT, "sweep"),
                      cs.GEOMETRY_MACRO, variants_of)
    for (lib, tag), (_, ptx) in built.items():
        for ln in ptx:
            print(f"ptxas {lib} {tag}: {ln}", flush=True)

    calls = main_path_calls(torch.device("cuda", 0))
    with torch.no_grad():
        refs = {what: plain() for what, (_, plain, _) in calls.items()}
    torch.cuda.synchronize()

    rows = {}
    order = [(lib, tag) for lib, vs in variants_of.items() for tag, _ in vs]
    for rnd, seq in enumerate((order, order[::-1])):
        for lib, tag in seq:
            _build._LIBS[lib] = ctypes.CDLL(built[(lib, tag)][0])
            for what, (kern, _, check) in calls.items():
                if not what.startswith(lib):
                    continue
                with torch.no_grad():
                    check(kern(), refs[what], f"{lib} {tag} {what}")
                    ms = cs.kernel_ms(kern)
                rows.setdefault((lib, tag, what), []).append(ms)
                print(f"round {rnd} {lib} {tag} {what}: {ms['graph_ms']:.5f} "
                      f"ms in a graph replay, {ms['ms']:.5f} ms one eager "
                      f"call", flush=True)
    print("library geometry what: graph replay ms (round 0, round 1)")
    for (lib, tag, what), r in rows.items():
        print(f"{lib} {tag} {what}: {r[0]['graph_ms']:.5f} "
              f"{r[1]['graph_ms']:.5f}")
    print(name_power)


if __name__ == "__main__":
    main()
