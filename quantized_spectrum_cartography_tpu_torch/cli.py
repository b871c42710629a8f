"""Command-line interface of the port: ``simulate`` and ``recover --solver
lowrank|mle-gan|dowjons``, with the JAX package's flags and one-line JSON
output.

    python -m quantized_spectrum_cartography_tpu_torch.cli simulate --out maps.npz
    python -m quantized_spectrum_cartography_tpu_torch.cli recover --solver lowrank
    python -m quantized_spectrum_cartography_tpu_torch.cli recover --solver mle-gan
    python -m quantized_spectrum_cartography_tpu_torch.cli recover \
        --solver dowjons --prior-kind gan --prior-checkpoint checkpoints/gan256/final
    python -m quantized_spectrum_cartography_tpu_torch.cli recover --config run.ini

All run on the GPU unless ``--device cpu`` is given.  The deep prior of
mle-gan and dowjons is the VAE of ``checkpoints/vae_best/final`` (in this
repository) unless ``--prior-checkpoint`` names another checkpoint
directory; with ``--prior-kind gan`` it is a Generator256 checkpoint
directory or an ``.npz`` of the generator's tree with "/"-joined keys
(``training.checkpoints.load_npz_tree``).  ``--config`` takes an INI or
JSON file (``config.load_config_file``) whose sections override the flags'
defaults, as in the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

_NOT_PORTED = "not yet ported to the PyTorch package (see ROADMAP.md Queue 1)"
DEFAULT_VAE = Path(__file__).resolve().parents[1] / "checkpoints" / \
    "vae_best" / "final"


class Recovery(NamedTuple):
    """A `recover` call set up: the simulated problem, and `run(**kw)`,
    which solves it (keyword arguments go to the solver, e.g.
    nll_mode="plain") and returns the one map's RecoveryResult.  Every
    run starts from the same random state, so two runs see the same
    draws."""

    problem: object
    run: Callable


def _generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _cmd_simulate(args):
    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_map_batch)

    cfg = PhysicsConfig(num_emitters=args.emitters,
                        shadow_sigma=args.shadow_sigma,
                        decorrelation_distance=args.xc,
                        psd_basis=args.basis)
    T, S, C, peaks = generate_map_batch(_generator(args.device, args.seed),
                                        cfg, args.batch, device=args.device)
    np.savez(args.out, T=T.cpu().numpy(), S=S.cpu().numpy(),
             C=C.cpu().numpy(), peaks=peaks.cpu().numpy())
    print(f"wrote {args.batch} maps to {args.out} "
          f"(T {tuple(T.shape)}, S {tuple(S.shape)}, C {tuple(C.shape)})")


def _recovery(args) -> Recovery:
    from quantized_spectrum_cartography_tpu_torch.config import (
        PhysicsConfig, load_config_file)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_onebit_problem)

    if args.fixture:
        raise SystemExit(f"--fixture: {_NOT_PORTED}")
    file_cfg = load_config_file(args.config) if args.config else None
    gen = _generator(args.device, file_cfg.seed if file_cfg else args.seed)
    prob = generate_onebit_problem(
        gen, file_cfg.physics if file_cfg else PhysicsConfig(),
        sample_fraction=(file_cfg.solver.sample_fraction if file_cfg
                         else args.fraction),
        device=args.device)
    if args.solver == "lowrank":
        run = _lowrank(args, file_cfg, gen, prob)
    else:
        run = _ordinal(args, file_cfg, gen, prob)
    state = gen.get_state()

    def run_from_state(**kw):
        gen.set_state(state)
        return run(**kw)

    return Recovery(prob, run_from_state)


def _lowrank(args, file_cfg, gen, prob):
    from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        dither_probit)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        RecoveryResult, recover_lowrank_mle)

    R, I, J, K = prob.shape
    T_obs = dither_probit(prob.T_true - prob.mean_slf, args.std, gen)
    scfg = file_cfg.solver if file_cfg else SolverConfig(
        max_iters=args.iters, s_inner_iters=5, c_inner_iters=5, lr_s=0.001,
        lr_c=0.001)
    S0 = torch.zeros((1, R, I, J), device=args.device)
    C0 = torch.full((1, R, K), 0.01, device=args.device)

    def run(**kw):
        res = recover_lowrank_mle(T_obs[None], S0, C0, scfg, prob.mean_slf,
                                  args.std, T_true=prob.T_true[None], **kw)
        return RecoveryResult(S=res.S[0], C=res.C[0], T_hat=res.T_hat[0],
                              nmses=res.nmses[0], costs=res.costs[0])

    return run


def _ordinal(args, file_cfg, gen, prob):
    """mle-gan and dowjons: the 4-bin log quantizer (or the config's) on the
    simulated map, an entry mask, the deep prior."""
    from quantized_spectrum_cartography_tpu_torch.config import (
        QuantizerConfig, SolverConfig)
    from quantized_spectrum_cartography_tpu_torch.ops import boundaries as B
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        quantize_log)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        sample_entry_mask)
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        recover_dowjons, recover_mle_gan)

    gen_apply, z_dim = _load_prior(args)
    if file_cfg and file_cfg.quantizer.num_bins > 0:
        qcfg = file_cfg.quantizer
    else:
        qcfg = QuantizerConfig(boundaries=B.QUANTIZATION_BOUNDARIES_4_BINS,
                               noise_std=args.std if args.std > 0.1 else 5.0,
                               log_offset=B.LOG_OFFSET_4)
    Y = quantize_log(prob.T_true, qcfg.noise_std, qcfg.boundaries,
                     qcfg.log_offset, gen)
    mask = sample_entry_mask(gen, tuple(Y.shape), args.fraction,
                             device=args.device)
    scfg = (dataclasses.replace(file_cfg.solver, z_dim=z_dim) if file_cfg
            else SolverConfig(max_iters=args.iters, z_dim=z_dim))
    solve = recover_mle_gan if args.solver == "mle-gan" else recover_dowjons

    def run(**kw):
        return solve(Y, mask, gen_apply, scfg, qcfg,
                     num_emitters=prob.shape[0], T_true=prob.T_true,
                     generator=gen, **kw)

    return run


def _load_prior(args):
    """(generator fn Z [N, z] -> S [N, 51, 51], z) from --prior-kind and
    --prior-checkpoint, as JAX ``cli.py:_load_prior``."""
    from quantized_spectrum_cartography_tpu_torch.models import Generator256
    from quantized_spectrum_cartography_tpu_torch.solvers import (
        load_vae_prior, make_generator_apply)
    from quantized_spectrum_cartography_tpu_torch.training import (
        load_checkpoint, load_generator, load_npz_tree)

    path = args.prior_checkpoint
    if args.prior_kind == "vae":
        gen_apply, latent, _ = load_vae_prior(path or str(DEFAULT_VAE),
                                              device=args.device)
        return gen_apply, latent
    if path:
        tree = load_npz_tree(path) if path.endswith(".npz") else \
            load_checkpoint(path)
        module, scale = load_generator(tree, 256, args.device)
    else:
        print("warning: no --prior-checkpoint; using untrained prior",
              file=sys.stderr)
        module, scale = Generator256(seed=args.seed).to(args.device), 1.0
    return make_generator_apply(module, scale), 256


def _cmd_recover(args):
    rec = _recovery(args)
    res = rec.run()
    costs, nmses = res.costs.cpu().numpy(), res.nmses.cpu().numpy()
    print(json.dumps({"solver": args.solver,
                      "final_cost": float(costs[-1]),
                      "final_nmse": float(nmses[-1]),
                      "iters": int(costs.shape[0])}))
    if args.out:
        prob = rec.problem
        np.savez(args.out, S=res.S.cpu().numpy(), C=res.C.cpu().numpy(),
                 T_hat=res.T_hat.cpu().numpy(), nmses=nmses, costs=costs,
                 T_true=prob.T_true.cpu().numpy(),
                 S_true=prob.S_true.cpu().numpy(),
                 C_true=prob.C_true.cpu().numpy())


def _parser():
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
                    help=".mat fixture path (else simulate; not yet ported)")
    pr.add_argument("--fraction", type=float, default=0.1)
    pr.add_argument("--std", type=float, default=0.008)
    pr.add_argument("--iters", type=int, default=100)
    pr.add_argument("--prior-checkpoint", default=None)
    pr.add_argument("--prior-kind", choices=["gan", "vae"], default="vae")
    pr.add_argument("--out", default=None)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--config", default=None,
                    help="INI/JSON config file ([physics] [quantizer] "
                         "[solver] sections); overrides the flag defaults")
    pr.add_argument("--device", default="cuda")
    pr.set_defaults(fn=_cmd_recover)
    return p


def recovery(argv) -> Recovery:
    """The `recover` command line `argv` (without the program name, e.g.
    ``["recover", "--solver", "mle-gan"]``) set up but not run."""
    args = _parser().parse_args(argv)
    if args.cmd != "recover":
        raise ValueError(f"not a recover command line: {argv}")
    return _recovery(args)


def main(argv=None):
    args = _parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
