"""Command-line interface of the port: ``simulate`` and ``recover --solver
lowrank``, with the JAX package's flags and one-line JSON output.

    python -m quantized_spectrum_cartography_tpu_torch.cli simulate --out maps.npz
    python -m quantized_spectrum_cartography_tpu_torch.cli recover --solver lowrank

Both run on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

_NOT_PORTED = "not yet ported to the PyTorch package (see ROADMAP.md Queue 1)"


def _generator(args):
    return torch.Generator(device=args.device).manual_seed(args.seed)


def _cmd_simulate(args):
    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_map_batch)

    cfg = PhysicsConfig(num_emitters=args.emitters,
                        shadow_sigma=args.shadow_sigma,
                        decorrelation_distance=args.xc,
                        psd_basis=args.basis)
    T, S, C, peaks = generate_map_batch(_generator(args), cfg, args.batch,
                                        device=args.device)
    np.savez(args.out, T=T.cpu().numpy(), S=S.cpu().numpy(),
             C=C.cpu().numpy(), peaks=peaks.cpu().numpy())
    print(f"wrote {args.batch} maps to {args.out} "
          f"(T {tuple(T.shape)}, S {tuple(S.shape)}, C {tuple(C.shape)})")


def _cmd_recover(args):
    from quantized_spectrum_cartography_tpu_torch.config import (
        PhysicsConfig, SolverConfig)
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        dither_probit)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_onebit_problem)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        recover_lowrank_mle)

    if args.solver != "lowrank":
        raise SystemExit(f"solver {args.solver}: {_NOT_PORTED}")
    if args.fixture or args.config:
        raise SystemExit(f"--fixture/--config: {_NOT_PORTED}")

    gen = _generator(args)
    prob = generate_onebit_problem(gen, PhysicsConfig(),
                                   sample_fraction=args.fraction,
                                   device=args.device)
    R, I, J, K = prob.shape
    T_obs = dither_probit(prob.T_true - prob.mean_slf, args.std, gen)
    scfg = SolverConfig(max_iters=args.iters, s_inner_iters=5,
                        c_inner_iters=5, lr_s=0.001, lr_c=0.001)
    S0 = torch.zeros((1, R, I, J), device=args.device)
    C0 = torch.full((1, R, K), 0.01, device=args.device)
    res = recover_lowrank_mle(T_obs[None], S0, C0, scfg, prob.mean_slf,
                              args.std, T_true=prob.T_true[None])
    costs, nmses = res.costs[0].cpu().numpy(), res.nmses[0].cpu().numpy()
    print(json.dumps({"solver": args.solver,
                      "final_cost": float(costs[-1]),
                      "final_nmse": float(nmses[-1]),
                      "iters": int(costs.shape[0])}))
    if args.out:
        np.savez(args.out, S=res.S[0].cpu().numpy(), C=res.C[0].cpu().numpy(),
                 T_hat=res.T_hat[0].cpu().numpy(), nmses=nmses, costs=costs,
                 T_true=prob.T_true.cpu().numpy(),
                 S_true=prob.S_true.cpu().numpy(),
                 C_true=prob.C_true.cpu().numpy())


def main(argv=None):
    p = argparse.ArgumentParser(prog="qsc-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("simulate", help="generate synthetic radio maps")
    ps.add_argument("--out", default="maps.npz")
    ps.add_argument("--batch", type=int, default=16)
    ps.add_argument("--emitters", type=int, default=2)
    ps.add_argument("--shadow-sigma", type=float, default=4.0)
    ps.add_argument("--xc", type=float, default=90.0)
    ps.add_argument("--basis", choices=["g", "s"], default="g")
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--device", default="cuda")
    ps.set_defaults(fn=_cmd_simulate)

    pr = sub.add_parser("recover", help="run a recovery solver")
    pr.add_argument("--solver", choices=["lowrank", "mle-gan", "dowjons"],
                    default="lowrank")
    pr.add_argument("--fixture", default=None,
                    help=".mat fixture path (else simulate)")
    pr.add_argument("--fraction", type=float, default=0.1)
    pr.add_argument("--std", type=float, default=0.008)
    pr.add_argument("--iters", type=int, default=100)
    pr.add_argument("--prior-checkpoint", default=None)
    pr.add_argument("--prior-kind", choices=["gan", "vae"], default="vae")
    pr.add_argument("--out", default=None)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--config", default=None,
                    help="INI/JSON config file (not yet ported)")
    pr.add_argument("--device", default="cuda")
    pr.set_defaults(fn=_cmd_recover)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
