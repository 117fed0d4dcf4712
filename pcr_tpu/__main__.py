"""CLI runner — the equivalent of the reference's L3 scripts.

The reference parameterizes its three entry-point scripts by editing constants
in source (SURVEY §5: ``n_clouds = 901`` at 1_...py:126, ``voxel_size = 0.1``
at 1_...py:131, iterations/scales at 2_...py:184-185).  Here the same knobs
are flags over the restartable stage runners in pcr_tpu/pipeline.py:

  python -m pcr_tpu stage1 --dataset Facade                 # FGR circuit
  python -m pcr_tpu stage2 --dataset Facade                 # M-GICP refine
  python -m pcr_tpu stage3 --dataset Facade                 # global shoot-out
  python -m pcr_tpu full   --dataset Facade --n 7           # all three
  python -m pcr_tpu report --dataset Facade                 # PLY/plot artifacts

Each stage persists poses in the reference's own text layout
(pose_{i+1}_{i}.txt / pose{i}.txt), so stages restart independently and
interoperate with the shipped fixture files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pcr_tpu",
        description="point-cloud registration with global refinement",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(sp):
        sp.add_argument("--dataset", default="Facade",
                        choices=["NCLT", "Facade", "Courtyard"])
        sp.add_argument("--n", type=int, default=None,
                        help="number of scans (default: full circuit)")
        sp.add_argument("--voxel-size", type=float, default=0.1)
        sp.add_argument("--output-root", default="outputs")
        sp.add_argument("--batch-size", type=int, default=1)
        sp.add_argument("--devices", type=int, default=None,
                        help="shard pairs over the first N local devices "
                             "('pairs' mesh; default: no mesh, one device)")
        sp.add_argument("--shard-points", type=int, default=None,
                        help="shard each pair's source rows over N devices "
                             "('points' mesh axis).  With --devices P this "
                             "builds the combined (P, N) pairs x points mesh "
                             "(stage2/full); alone on 'pair' it builds the "
                             "1-D 'points' mesh for one TLS-scale pair")
        return sp

    add_common(sub.add_parser("stage1", help="FGR coarse pairwise registration"))
    s2 = add_common(sub.add_parser("stage2", help="multi-scale GICP refinement"))
    s2.add_argument("--scales", type=int, default=5)
    s2.add_argument("--iterations", type=int, default=100)
    s2.add_argument("--init", default=None,
                    help="relative-pose dir for initialization "
                         "(default: this run's stage-1 output; 'reference' "
                         "uses the shipped FGR fixtures)")
    s3 = add_common(sub.add_parser("stage3", help="global refinement shoot-out"))
    s3.add_argument("--methods", nargs="+",
                    default=["LUM", "SLERP", "SLERP_LUM", "pose_graph"])
    s3.add_argument("--relative", default=None,
                    help="relative-pose dir (default: this run's stage-2 "
                         "output; 'reference' uses the shipped FGR_GICP fixtures)")
    f = add_common(sub.add_parser("full", help="stages 1-3 end to end"))
    f.add_argument("--scales", type=int, default=5)
    f.add_argument("--iterations", type=int, default=100)
    pr = add_common(sub.add_parser(
        "pair", help="register one scan pair (for incomplete circuits, "
                     "e.g. Courtyard which ships only s2/s4)"))
    pr.add_argument("--src", type=int, required=True)
    pr.add_argument("--tgt", type=int, required=True)
    pr.add_argument("--init", default="fgr", choices=["fgr", "fixture"])
    pr.add_argument("--scales", type=int, default=5)
    pr.add_argument("--iterations", type=int, default=100)
    r = add_common(sub.add_parser("report", help="export trajectories + error plots"))
    r.add_argument("--methods", nargs="+",
                   default=["LUM", "SLERP", "SLERP_LUM", "pose_graph"])
    return p


def _config(args) -> "pipeline.PipelineConfig":
    from . import pipeline

    kw = dict(dataset=args.dataset, voxel_size=args.voxel_size,
              output_root=args.output_root, batch_size=args.batch_size)
    if getattr(args, "scales", None) is not None:
        kw["mgicp_scales"] = args.scales
    if getattr(args, "iterations", None) is not None:
        kw["mgicp_iterations"] = args.iterations
    return pipeline.PipelineConfig(**kw)


def _load_init(args, cfg, n, stage_dir, fixture_kind):
    import numpy as np

    from .utils import poses_io

    src = getattr(args, "init", None) or getattr(args, "relative", None)
    if src == "reference":
        rel = poses_io.load_reference_relative(fixture_kind, cfg.dataset)
        return np.asarray(rel)[:n]
    if src:
        return poses_io.load_relative_circuit(src, n)
    return poses_io.load_relative_circuit(cfg.out_dir(stage_dir), n)


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    cfg = _config(args)

    from . import pipeline
    from .utils import poses_io

    n = args.n or poses_io.CIRCUIT_SIZES[cfg.dataset]
    t0 = time.time()
    summary: dict = {"command": args.command, "n": n,
                     "config": dataclasses.asdict(cfg)}
    mesh = None
    if (getattr(args, "devices", None) and getattr(args, "shard_points", None)
            and args.command != "pair"):
        # combined pairs x points mesh — every pair's source rows split over
        # 'points' during the stage-2 solve (parallel.point_sharding
        # .sharded_mgicp_2d)
        from .parallel import mesh as mesh_mod

        mesh = mesh_mod.make_2d_mesh(args.devices, args.shard_points)
        summary["mesh"] = {"pairs": args.devices, "points": args.shard_points}
    elif getattr(args, "devices", None):
        from .parallel import mesh as mesh_mod

        mesh = mesh_mod.make_pair_mesh(args.devices)
        summary["mesh"] = {"pairs": args.devices}

    def stage2_rates(metrics):
        """Success at the gate's intended measurement (full-cloud fitness at
        2*voxel — what _retry_pair scores) plus the finest-scale rate for
        reference (0.1 m correspondences read misleadingly low outdoors)."""
        return {
            "success_rate": metrics.success_rate(
                cfg.fitness_gate, key="gate_fitness", stage="mgicp"),
            "success_rate_finest_scale": metrics.success_rate(
                cfg.fitness_gate, stage="mgicp"),
        }

    if args.command == "stage1":
        metrics = pipeline.PairMetrics()
        pipeline.run_stage1_fgr(cfg, n=n, metrics=metrics, mesh=mesh)
        summary["success_rate"] = metrics.success_rate(cfg.fitness_gate)
    elif args.command == "stage2":
        init = _load_init(args, cfg, n, "relative_poses_FGR", "FGR")
        metrics = pipeline.PairMetrics()
        pipeline.run_stage2_mgicp(cfg, init_poses=init, n=n, metrics=metrics,
                                  mesh=mesh)
        summary.update(stage2_rates(metrics))
    elif args.command == "stage3":
        rel = _load_init(args, cfg, n, "relative_poses_FGR_GICP", "FGR_GICP")
        results = pipeline.run_stage3_global(
            cfg, relative_poses=rel, n=n, methods=tuple(args.methods))
        summary["methods"] = sorted(results)
    elif args.command == "full":
        from .utils import cloud as cloud_mod

        metrics = pipeline.PairMetrics()
        clouds = pipeline._load_circuit_clouds(cfg, range(n))
        if mesh is None and cfg.batch_size <= 1:
            # single-chip path: stage 2 streams behind stage 1 in one
            # dispatch window (pipeline.run_full)
            out = pipeline.run_full(cfg, clouds=clouds, n=n, metrics=metrics)
            results = out["stage3"]
        else:
            rel1 = pipeline.run_stage1_fgr(cfg, clouds=clouds, n=n,
                                           metrics=metrics, mesh=mesh)
            rel2 = pipeline.run_stage2_mgicp(
                cfg, init_poses=rel1, clouds=clouds, n=n, metrics=metrics,
                mesh=mesh)
            results = pipeline.run_stage3_global(
                cfg, relative_poses=rel2, clouds=clouds, n=n)
        summary["methods"] = sorted(results)
        summary.update(stage2_rates(metrics))
        summary["stage1_success_rate"] = metrics.success_rate(
            cfg.fitness_gate, stage="fgr")
    elif args.command == "pair":
        pmesh = None
        if getattr(args, "shard_points", None):
            from .parallel import mesh as mesh_mod

            pmesh = mesh_mod.make_point_mesh(args.shard_points)
        out = pipeline.run_pair(cfg, args.src, args.tgt, init=args.init,
                                point_mesh=pmesh)
        summary.update(out)
    elif args.command == "report":
        import numpy as np

        from . import viz

        results = {}
        for name in args.methods:
            try:
                results[name] = poses_io.load_absolute_poses(
                    cfg.out_dir(f"absolute_poses_{name}"), n)
            except FileNotFoundError:
                print(f"skipping {name}: no saved poses", file=sys.stderr)
        try:
            ref = np.asarray(poses_io.load_reference_absolute(cfg.dataset))[:n]
        except (FileNotFoundError, KeyError):
            ref = None
        paths = viz.report_circuit(cfg.out_dir("report"), None, results, reference=ref)
        summary["artifacts"] = paths

    summary["seconds"] = round(time.time() - t0, 2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
