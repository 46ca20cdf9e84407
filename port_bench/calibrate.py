"""The readings that a cell's correctness limits are set from, in one process:

    python3 -m port_bench.calibrate --workload <cell> --seconds <s> \\
        --seeds 1,2,... --control-seeds 7,8,9

For each of ``--seeds`` a whole run of the cell (the port, its window, the
check against the float32 reference) and its numbers; for each of
``--control-seeds`` the control: the reference in bfloat16 put in the port's
place (the window's frames, or a fit's checked steps) and compared with the
float32 reference as the port is, with any fault the kind plants in the
reference in the port's place (a fit's loss over half of the image's
columns). One JSON line each. Needs a card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import core, harness  # noqa: E402
from .reference import camera as ref_camera  # noqa: E402
from .reference import fit as ref_fit  # noqa: E402
from .reference import strict_float32  # noqa: E402


def _kind(name: str, seed: int, seconds: float, manifest: core.Manifest):
    """A cell's traffic after its set-up, its window and the port's release."""
    from .system import Port
    strict_float32()
    cell = manifest.cell(name)
    kind = manifest.kind(cell.traffic["kind"])(Port("cuda"), cell.config, cell.traffic,
                                               cell.params, seed)
    kind.setup(seconds)
    kind.window(seconds)
    kind.release()
    torch.cuda.empty_cache()
    return kind


def control(name: str, seed: int, seconds: float, manifest: core.Manifest) -> dict:
    """The control's numbers (the bfloat16 reference in the port's place) and
    those of the faults the kind plants in the reference."""
    return _kind(name, seed, seconds, manifest).control_readings(torch.bfloat16)


def witness(name: str, seed: int, seconds: float, manifest: core.Manifest) -> dict:
    """A fit's numbers three ways: the port against the float32 reference, the
    port against the reference in float64, and the float32 reference against
    the float64 one (how far float32 itself carries each number); and each
    sampled step's numbers apart, with its fit, stage, step and tau."""
    kind = _kind(name, seed, seconds, manifest)
    f32, f64, prog = kind._reference(), kind._reference(torch.float64), kind._program()

    def one(a, b, i):
        return {k: v for k, v in kind.compare(dict(a, steps=[a["steps"][i]]),
                                              dict(b, steps=[b["steps"][i]])).items()
                if k.startswith("step_")}
    return {"program": kind.compare(prog, f32), "program_vs_f64": kind.compare(prog, f64),
            "f32_vs_f64": kind.compare(f32, f64), "sensitivity": sensitivity(kind),
            "steps": [{"key": r["key"], "tau": r["tau"], "program": one(prog, f32, i),
                       "f32_vs_f64": one(f32, f64, i)} for i, r in enumerate(kind.sampled)]}


def sensitivity(kind, draws: int = 4) -> list:
    """How far the exact first gradient of a fit's checked steps moves when
    every input (the scene of both sides and the camera) is moved by float32's
    rounding, a relative ``2**-24`` normal draw an element: for each draw, the
    gap of norms (as ``grad_gap`` reads it) of the float64 reference's first
    gradient at the moved inputs against the one at the inputs themselves."""
    def first(arrays, init, cam):
        pos, rot, fov = (torch.as_tensor(np.asarray(x, np.float64)) for x in cam)
        c = ref_camera.Camera(pos, rot, fov, (kind.W, kind.H)).to(kind.ref_device(),
                                                                  torch.float64)
        out = ref_fit.follow_soft_fit(c, kind.ref_scene(torch.float64, arrays),
                                      kind.ref_scene(torch.float64, init), kind.taus[0],
                                      kind.lr, kind.trainable, steps=1)
        return {k: v.cpu().numpy() for k, v in out["grad"].items()}
    rng = np.random.default_rng(kind.seed & (2 ** 64 - 1))

    def moved(d):
        return {k: np.asarray(v, np.float64) * (1.0 + 2.0 ** -24 * rng.standard_normal(
            np.shape(v))) for k, v in d.items()}
    base = first(kind.arrays, kind.checked_init, kind.cam_arrays)
    out = []
    for _ in range(draws):
        cam = [np.asarray(x, np.float64) * (1.0 + 2.0 ** -24 * rng.standard_normal(np.shape(x)))
               for x in kind.cam_arrays]
        g = first(moved(kind.arrays), moved(kind.checked_init), cam)
        out.append(kind.norm_gap(g, base))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="", help="a fit's seeds to read against "
                                                         "the float64 reference too")
    args = ap.parse_args(argv)
    manifest = core.Manifest()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t,
                               manifest=manifest)
        print(json.dumps({"seed": seed, "program": {k: c["value"] for k, c in
                                                    out["checks"].items()},
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()}}),
              flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        print(json.dumps({"seed": seed, **control(args.workload, seed, args.seconds,
                                                  manifest)}), flush=True)
    for seed in [int(s) for s in args.witness_seeds.split(",") if s]:
        print(json.dumps({"seed": seed, **witness(args.workload, seed, args.seconds,
                                                  manifest)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
