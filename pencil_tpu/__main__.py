"""Command-line interface (reference L9: ``pc_start`` / ``pc_run`` /
``pc_auto-test`` analogs).

    python -m pencil_tpu start <rundir>          # build IC, write var.npz
    python -m pencil_tpu run   <rundir> [--nt N] [--sharded]
    python -m pencil_tpu bench [--n N] [--cpu]
    python -m pencil_tpu export <rundir>         # data/ in reference layout
"""
from __future__ import annotations

import argparse
import os
import sys


def _load(rundir):
    from .compat.rundir import load_print_in, load_rundir
    cfg, info = load_rundir(rundir)
    cols = load_print_in(rundir)
    return cfg, info, cols


def cmd_start(args):
    from .io.snapshot import save_snapshot
    from .model import Model
    cfg, info, _ = _load(args.rundir)
    model = Model(cfg)
    state = model.init_state(args.seed, overrides=info.get("init_overrides"))
    datadir = os.path.join(args.rundir, "data")
    os.makedirs(datadir, exist_ok=True)
    save_snapshot(os.path.join(datadir, "var.npz"), state)
    print(f"start: wrote {datadir}/var.npz "
          f"({cfg.grid.nx}x{cfg.grid.ny}x{cfg.grid.nz}, "
          f"{len(cfg.modules)} modules)")


def cmd_run(args):
    from .model import Model
    from .run import Run, RunParams
    cfg, info, cols = _load(args.rundir)
    model = Model(cfg)
    datadir = os.path.join(args.rundir, "data")
    def _aver_in(*names):
        out = []
        for nm in names:
            fp = os.path.join(args.rundir, nm)
            if os.path.exists(fp):
                out += [ln.strip() for ln in open(fp)
                        if ln.strip() and not ln.startswith("#")]
        return tuple(out)

    rp = info.get("run_pars", {})
    downs = rp.get("downsampl", ())
    downs = tuple(int(d) for d in (downs if isinstance(downs, list)
                                   else [downs])) if downs else ()
    params = RunParams(
        nt=args.nt or info["nt"], it1=info["it1"], isave=info["isave"],
        dsnap=info["dsnap"], dvid=info["dvid"], print_columns=cols,
        it1d=int(rp.get("it1d", info["it1"])),
        aver_names=_aver_in("xyaver.in", "xzaver.in", "yzaver.in",
                            "zaver.in", "yaver.in"),
        phiaver_names=_aver_in("phiaver.in"),
        d2davg=float(rp.get("d2davg", info["dsnap"] or 0.0)),
        tavg=float(rp.get("tavg", 0.0)),
        downsampl=downs if any(d > 1 for d in downs) else (),
        dsnap_down=float(rp.get("dsnap_down", 0.0)))
    run = Run(model, datadir=datadir, params=params, sharded=args.sharded)
    if os.path.exists(os.path.join(datadir, "var.npz")) and not args.fresh:
        state = run.resume()
    else:
        state = model.init_state(args.seed, overrides=info.get("init_overrides"))
    run.main_loop(state)


def cmd_bench(args):
    os.environ.setdefault("BENCH_N", str(args.n))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    bench.main(["--cpu"] if args.cpu else [])


def cmd_export(args):
    import numpy as np
    from .compat.io_dist import (export_state, write_dim, write_grid,
                                 write_param_nml)
    from .io.snapshot import load_snapshot
    from .model import Model
    cfg, info, _ = _load(args.rundir)
    model = Model(cfg)
    datadir = os.path.join(args.rundir, "data")
    state = load_snapshot(os.path.join(datadir, "var.npz"))
    out = os.path.join(datadir, "proc0")
    export_state(model, state, out)
    gs = cfg.grid
    write_dim(os.path.join(datadir, "dim.dat"), gs.mx, gs.my, gs.mz,
              model.reg.nvar, model.reg.nf - model.reg.nvar)
    write_grid(os.path.join(datadir, "grid.dat"),
               np.asarray(model.grid.x), np.asarray(model.grid.y),
               np.asarray(model.grid.z), (gs.dx, gs.dy, gs.dz),
               (gs.Lx, gs.Ly, gs.Lz), t=float(np.asarray(state["t"])))
    write_param_nml(os.path.join(datadir, "param.nml"), model)
    import shutil
    shutil.copy(os.path.join(out, "index.pro"),
                os.path.join(datadir, "index.pro"))
    print(f"export: reference-layout data dir at {datadir}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pencil_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="generate initial condition (start.x)")
    p.add_argument("rundir")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("run", help="time-step a run directory (run.x)")
    p.add_argument("rundir")
    p.add_argument("--nt", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--fresh", action="store_true",
                   help="ignore existing checkpoint")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("bench", help="single-device benchmark")
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--cpu", action="store_true",
                   help="time the CPU (results are labelled cpu)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("export", help="export data/ in reference layout")
    p.add_argument("rundir")
    p.set_defaults(fn=cmd_export)

    args = ap.parse_args(argv)
    from .compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
