"""LandModel XLA-scan rate on its own, at a chosen surface-update policy.

Same flagship composition as ``bench.py``'s land path — rain pulse + pond
store + MOST evaporation + coupled water/energy soil — run through the
plain jit ``lax.scan``, timed with ``block_until_ready`` after a compiling
first call.

Usage:  python benchmarks/bench_land_xla.py [--nz 64 --ncol 65536]
        python benchmarks/bench_land_xla.py --smoke    # tiny CPU run
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nz", type=int, default=64)
    p.add_argument("--ncol", type=int, default=65536)
    p.add_argument("--steps", type=int, default=96)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--surface-update", type=str, default="stage",
                   choices=("stage", "step"))
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args()

    import jax

    from bench import (
        build_land,
        gpu_name_and_power_limit,
        require_gpu,
        scan_run,
        timed,
    )
    from landhydrology.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
        args.nz, args.ncol, args.steps = 16, 1024, 16
        card = None
    else:
        require_gpu()
        card = gpu_name_and_power_limit()

    import jax.numpy as jnp

    from landhydrology.models.land import wrap_stepper_for_land
    from landhydrology.timestepping import SSPRK33

    dtype = jnp.float32
    land, Y, Ya = build_land(
        args.nz, args.ncol, dtype, surface_update=args.surface_update
    )
    run = scan_run(
        land.make_rhs(),
        wrap_stepper_for_land(SSPRK33(), land),
        jnp.asarray(args.dt, dtype=dtype),
        args.steps,
    )
    first, best, _ = timed(run, Y, Ya, jnp.asarray(0.0, dtype=dtype))
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "LandModel (rain+pond+MOST+energy) XLA-scan grid-points/s",
        "value": args.nz * args.ncol * args.steps / best,
        "detail": {
            "nz": args.nz, "ncol": args.ncol, "steps": args.steps,
            "surface_update": args.surface_update,
            "first_call_s": first, "best_s": best,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
        },
    }))


if __name__ == "__main__":
    main()
