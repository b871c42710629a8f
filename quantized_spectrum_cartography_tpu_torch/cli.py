"""Command-line interface of the port: ``simulate`` and ``recover --solver
lowrank|mle-gan``, with the JAX package's flags and one-line JSON output.

    python -m quantized_spectrum_cartography_tpu_torch.cli simulate --out maps.npz
    python -m quantized_spectrum_cartography_tpu_torch.cli recover --solver lowrank
    python -m quantized_spectrum_cartography_tpu_torch.cli recover \
        --solver mle-gan --prior-kind gan [--prior-checkpoint gan256.npz]

All run on the GPU unless ``--device cpu`` is given.  A prior checkpoint is
an ``.npz`` of the JAX package's generator tree with "/"-joined keys
(``training.checkpoints.load_npz_tree``).
"""

from __future__ import annotations

import argparse
import json
import sys

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

    if args.solver not in ("lowrank", "mle-gan"):
        raise SystemExit(f"solver {args.solver}: {_NOT_PORTED}")
    if args.fixture or args.config:
        raise SystemExit(f"--fixture/--config: {_NOT_PORTED}")

    gen = _generator(args)
    prob = generate_onebit_problem(gen, PhysicsConfig(),
                                   sample_fraction=args.fraction,
                                   device=args.device)
    R, I, J, K = prob.shape
    if args.solver == "lowrank":
        T_obs = dither_probit(prob.T_true - prob.mean_slf, args.std, gen)
        scfg = SolverConfig(max_iters=args.iters, s_inner_iters=5,
                            c_inner_iters=5, lr_s=0.001, lr_c=0.001)
        S0 = torch.zeros((1, R, I, J), device=args.device)
        C0 = torch.full((1, R, K), 0.01, device=args.device)
        res = recover_lowrank_mle(T_obs[None], S0, C0, scfg, prob.mean_slf,
                                  args.std, T_true=prob.T_true[None])
        S, C, T_hat = res.S[0], res.C[0], res.T_hat[0]
        costs, nmses = res.costs[0], res.nmses[0]
    else:
        res = _recover_mle_gan(args, gen, prob, R)
        S, C, T_hat, costs, nmses = res.S, res.C, res.T_hat, res.costs, \
            res.nmses
    costs, nmses = costs.cpu().numpy(), nmses.cpu().numpy()
    print(json.dumps({"solver": args.solver,
                      "final_cost": float(costs[-1]),
                      "final_nmse": float(nmses[-1]),
                      "iters": int(costs.shape[0])}))
    if args.out:
        np.savez(args.out, S=S.cpu().numpy(), C=C.cpu().numpy(),
                 T_hat=T_hat.cpu().numpy(), nmses=nmses, costs=costs,
                 T_true=prob.T_true.cpu().numpy(),
                 S_true=prob.S_true.cpu().numpy(),
                 C_true=prob.C_true.cpu().numpy())


def _load_prior(args):
    """(generator fn Z [N, 256] -> S [N, 51, 51], z_dim) from --prior-kind
    and --prior-checkpoint, as JAX ``cli.py:_load_prior``."""
    from quantized_spectrum_cartography_tpu_torch.models import Generator256
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        make_generator_apply)
    from quantized_spectrum_cartography_tpu_torch.training import (
        load_generator, load_npz_tree)

    if args.prior_kind != "gan":
        raise NotImplementedError(
            f"--prior-kind {args.prior_kind}: the VAE prior is not yet "
            "ported to the PyTorch package (ROADMAP.md Queue 1, item 7); "
            "use --prior-kind gan")
    if args.prior_checkpoint:
        module, scale = load_generator(load_npz_tree(args.prior_checkpoint),
                                       256, args.device)
    else:
        print("warning: no --prior-checkpoint; using untrained prior",
              file=sys.stderr)
        module, scale = Generator256(seed=args.seed).to(args.device), 1.0
    return make_generator_apply(module, scale), 256


def _recover_mle_gan(args, gen, prob, R):
    from quantized_spectrum_cartography_tpu_torch.config import (
        QuantizerConfig, SolverConfig)
    from quantized_spectrum_cartography_tpu_torch.ops import boundaries as B
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        quantize_log)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        sample_entry_mask)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        recover_mle_gan)

    gen_apply, z_dim = _load_prior(args)
    qcfg = QuantizerConfig(boundaries=B.QUANTIZATION_BOUNDARIES_4_BINS,
                           noise_std=args.std if args.std > 0.1 else 5.0,
                           log_offset=B.LOG_OFFSET_4)
    Y = quantize_log(prob.T_true, qcfg.noise_std, qcfg.boundaries,
                     qcfg.log_offset, gen)
    mask = sample_entry_mask(gen, tuple(Y.shape), args.fraction,
                             device=args.device)
    scfg = SolverConfig(max_iters=args.iters, z_dim=z_dim)
    return recover_mle_gan(Y, mask, gen_apply, scfg, qcfg, num_emitters=R,
                           T_true=prob.T_true, generator=gen)


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
