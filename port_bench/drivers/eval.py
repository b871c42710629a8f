"""Offline evaluation: back-to-back calls of the harness's DowJons on batches
of base-condition examples, closed loop.

Traffic: `batch` problems a call, cycled from a pool of `pool_batches`
batches made in set-up (maps, observed locations and the solver's starts).
Set-up warms every shape with a call of one outer iteration.  The window
runs whole calls, each ended by a device synchronize, until `--seconds`
have passed; `maps_per_s` is all its examples over all its time.

The check: `sample_examples` examples drawn from the seed among the
window's; the float64 reference (`reference/dowjons.py`) solves each again
from the same maps, locations and starts.  The latent steps are chaotic:
on the card the init fit's costs part from the reference's by rounding
after about 10 of its 150 steps (1e-6 to 1e-4 by step 20, 1e-2 by step
150), and an outer iteration of 20 z-steps multiplies a gap by about ten.
So the reference runs the init fit from the handed-in start, its first
`init_steps` costs held to rounding and the rest loosely, and the winner's
outer iterations from the program's own start of that restart (`Z_start`:
restart 0's is the init fit's end), the first `early_iters` held to
rounding and the rest loosely.  A few examples in a hundred part from the
reference within one outer iteration (a cost gap of 1e-4 to 2e-3, where
the median example reads 1e-6), so the trajectory's numbers are medians
over the checked examples of each one's worst gap, and `parted` counts the
examples that part by far more than chaos does.  Numbers:
- `init_gap`: the median over the examples of the worst relative gap of
  SPA's start, of the restarts' handed-in starts, and of the init fit's
  first `init_steps` costs, step by step, against the reference's;
- `early_cost_gap`: the median of the worst per-iteration relative gap of
  the winning restart's costs over the first `early_iters` outer
  iterations, against the reference's costs of that restart from the same
  start;
- `late_cost_gap`: the same over the iterations after them;
- `parted`: how many checked examples read above `part_at` on any of
  their first `init_steps` init costs (`init`), their later init costs
  (`init_late`, the worst relative gap against the reference's from step
  `init_steps` to the fit's end) or their early iterations (`early`): the
  init fit's late steps, chaotic, are held here alone, and a fault
  confined to a minority of the examples passes the medians;
- `iters_gap`: how many outer iterations a call recorded fewer or more
  than the configuration's (exact, 0), the worst;
- `map_gap`: the worst gap of the returned S, C and T_hat against the
  reference's G(Z), its C-step on G(Z) and their product, all at the
  returned latents Z (no trajectory: float32 rounding alone);
- `pick_gap`: the worst, over the examples, of the winner's residual in
  excess of the least of the restarts' final residuals (0 when `best` is
  their argmin), and of the gap of the winner's residual against the
  reference's masked residual at the returned Z and C.
SPA's picks among bands of one emitter alone tie exactly; the reference
takes the program's (`reference.dowjons.spa`).  Examples whose picks are
near-tied between bands that give another start are left out of the
trajectory's numbers and counted on standard error.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from port_bench import check, roofline_decoder
from port_bench import dowjons_inputs as inputs
from port_bench.harness import spans
from port_bench.reference import dowjons as ref
from port_bench.reference.numerics import JUDGE

KEYS = ("T_hat", "S", "C", "S_init", "costs", "Z", "best", "residuals",
        "init_costs", "Z_start")


def program_solver(cell, weights) -> Callable:
    """The system under test: the harness registry's DowJons under the
    port's VAE decoder (`make_vae_generator` on the flax tree of the
    benchmark's weights), as `cli conditions --vae-checkpoint` builds it,
    with the benchmark's starts handed in."""
    from quantized_spectrum_cartography_tpu_torch.baselines.harness import (
        standard_methods)
    from quantized_spectrum_cartography_tpu_torch.solvers.vae_prior import (
        make_vae_generator)

    pr, sv = cell.config["prior"], cell.config["solver"]
    G = make_vae_generator(
        weights["flax"], latent_dim=pr["latent_dim"], beta=pr["beta"],
        amp=pr["amp"], head=pr["head"], dec_width=pr["dec_width"],
        refine_width=pr["refine_width"], device=cell.device)
    method = standard_methods(
        gen_apply=G, z_dim=pr["latent_dim"], dowjons_iters=sv["max_iters"],
        dowjons_restarts=sv["restarts"], dowjons_z_steps=sv["s_inner_iters"],
        dowjons_nnls_iters=sv["c_inner_iters"],
        dowjons_init_steps=sv["init_steps"])["dowjons"]

    def solve(hp, draws):
        with torch.no_grad():
            out = method(None, hp, draws=draws)
        out = dict(out, S=out["S_hat"], C=out["C_hat"])
        return {k: out[k] for k in KEYS}
    return solve


def control_solver(cell, weights) -> Callable:
    """The reference in TF32, in the program's place."""
    cfg = cell.config

    def solve(hp, draws):
        out = ref.solve(hp.T_obs, hp.Om, weights["torch"], cfg["prior"],
                        draws, cfg["solver"], ref.CONTROL)
        return {k: out[k] for k in KEYS}
    return solve


@dataclasses.dataclass
class State:
    cell: object
    weights: dict
    pool: list
    solve: Callable
    kept: list = dataclasses.field(default_factory=list)
    chosen: Optional[list] = None
    per_map: Optional[list] = None      # each checked example's gaps


def sync(cell):
    if torch.device(cell.device).type == "cuda":
        torch.cuda.synchronize()


def problems(cell, batches) -> list:
    """The program's `HarnessProblem`s of the benchmark's draws (built by
    `baselines.harness.problem_from_draws`, as the harness builds its
    examples), each with its starts."""
    from quantized_spectrum_cartography_tpu_torch.baselines.harness import (
        Condition, problem_from_draws)

    ph = cell.config["physics"]
    cond = Condition(fraction=ph["fraction"], num_emitters=ph["num_emitters"],
                     shadow_sigma=ph["shadow_sigma"],
                     xc=ph["decorrelation_distance"], snr=ph["snr"])
    return [{"hp": problem_from_draws(b["T"], b["S"], b["C"], b["peaks"],
                                      cond, None, b["perm"]),
             "draws": b["draws"]} for b in batches]


def one_iteration(cell):
    """The cell with its solve cut to one outer iteration."""
    cfg = cell.config
    return dataclasses.replace(cell, config=dict(
        cfg, solver=dict(cfg["solver"], max_iters=1)))


def setup(cell, solver=None) -> State:
    cfg, tr = cell.config, cell.workload["traffic"]
    gen = torch.Generator(device=cell.device).manual_seed(int(cell.seed))
    w = inputs.decoder_weights(gen, cfg["prior"])
    weights = {"torch": w, "flax": inputs.flax_tree(w, cfg["prior"])}
    pool = problems(cell, inputs.example_batches(
        gen, cfg, tr["batch"], tr["pool_batches"]))
    make = solver or program_solver
    # warm: a call of one outer iteration runs every shape of the solve
    # (the init fit's, the restarts', the C-steps' and the pick's)
    make(one_iteration(cell), weights)(pool[0]["hp"], pool[0]["draws"])
    sync(cell)
    return State(cell, weights, pool, make(cell, weights))


def measure(st: State) -> dict:
    cell = st.cell
    B = cell.workload["traffic"]["batch"]
    skip = cell.workload["trace"]["skip_units"]
    trace = None
    t0 = time.perf_counter()
    ends = [t0]
    j = 0
    while True:
        p = st.pool[j % len(st.pool)]
        if cell.trace and j == skip:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            from port_bench.trace import STRETCH, from_profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(STRETCH):
                    out = st.solve(p["hp"], p["draws"])
                    sync(cell)
        else:
            out = st.solve(p["hp"], p["draws"])
            sync(cell)
        st.kept.append(out)
        del out
        j += 1
        ends.append(time.perf_counter())
        if (ends[-1] - t0 >= cell.seconds
                and not (cell.trace and j <= skip)):
            break
    elapsed = time.perf_counter() - t0
    if cell.trace:
        trace = from_profile(prof)
    return {"metrics": {"maps_per_s": j * B / elapsed},
            "attempted": j * B, "failed": 0, "trace": trace, "units": 1,
            "work": roofline_decoder.dowjons_call(cell.config, B),
            "stderr": [f"window {elapsed:.6f} s, {j} calls of {B} examples;"
                       f" each {spans(ends)}"]}


def release(st: State, window: dict) -> None:
    """Keep the sampled examples' inputs and answers; free the rest."""
    cell = st.cell
    B = cell.workload["traffic"]["batch"]
    chosen = check.sample(cell.seed, len(st.kept) * B,
                          cell.workload["check"]["sample_examples"], salt=-3)
    st.chosen = []
    for i in chosen:
        j, b = divmod(i, B)
        p = st.pool[j % len(st.pool)]
        hp = p["hp"]
        st.chosen.append({
            "key": (j % len(st.pool), b),
            "T_obs": hp.T_obs[b], "Om": hp.Om[b],
            "draws": tuple(d[b] for d in p["draws"]),
            "out": {k: v[b] for k, v in st.kept[j].items()}})
    st.kept, st.pool, st.solve = [], [], None
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()


def _pick_gap(out: dict, residual) -> float:
    """The winner's residual in excess of the least of the restarts', and
    its gap against the reference's `residual` at the returned Z and C."""
    res = out["residuals"].double()
    won, least = res[out["best"]], res.min()
    return check.worst([(won - least) / least,
                        check.rel_gap(won[None], residual[None], None)])


def check_numbers(st: State, window: dict) -> dict:
    cfg, chk = st.cell.config, st.cell.workload["check"]
    sv, pr = cfg["solver"], cfg["prior"]
    n_init, n_early, part = chk["init_steps"], chk["early_iters"], \
        chk["part_at"]
    n = sv["restarts"]
    c = st.chosen

    def stack(f):
        return torch.stack([f(x["out"]) for x in c])

    T_obs = torch.stack([x["T_obs"] for x in c])
    prob = ref.Problem(T_obs, torch.stack([x["Om"] for x in c]),
                       st.weights["torch"], pr, sv, JUDGE)
    R = c[0]["draws"][0].shape[-2]
    best = stack(lambda o: o["best"])
    valid = (best >= 0) & (best < n)
    rows = torch.arange(len(c), device=best.device)
    with torch.no_grad():
        S_init, tied, followed = prob.spa(R, follow=stack(
            lambda o: o["S_init"]))
    _, init_costs = ref.init_fit(prob, S_init, torch.stack(
        [x["draws"][0] for x in c]), sv["init_steps"])
    with torch.no_grad():
        # the winner's outer iterations from the program's own start
        Z0 = stack(lambda o: o["Z_start"])[rows, best.clamp(0, n - 1)]
        _, costs, _, _, _ = ref.outer(prob, Z0[:, None], sv["max_iters"])
        Z = stack(lambda o: o["Z"])
        S = prob.G(Z)
        C = prob.c_step(S)
        T = ref.get_tensor(S, C, JUDGE)
        residual = prob.z_loss(Z[:, None], JUDGE.cast(stack(
            lambda o: o["C"]))[:, None])
    st.per_map = []
    init_gap, early, late, off, map_gap, pick_gap = [], [], [], [], [], []
    ties = parted = 0
    for i, x in enumerate(c):
        o = x["out"]
        off.append(float(abs(sv["max_iters"] - o["costs"].shape[-1])))
        map_gap.append(check.worst([check.rel_gap(o["S"], S[i], None),
                                    check.rel_gap(o["C"], C[i], None),
                                    check.rel_gap(o["T_hat"], T[i], None)]))
        pick_gap.append(_pick_gap(o, residual[i, 0]) if bool(valid[i])
                        else float("inf"))
        if bool(tied[i]):
            ties += 1
            continue
        got, want = o["init_costs"], init_costs[i]
        m = min(n_init, got.shape[-1])
        gi = check.worst([
            check.rel_gap(o["S_init"], S_init[i], None),
            check.rel_gap(o["Z_start"][1:], x["draws"][1][1:], None)
            if n > 1 else 0.0,
            check.rel_gap(got[:m, None], want[:m, None], (1,))
            if m == n_init else float("inf")])
        gl = (float("inf") if got.shape[-1] != want.shape[-1]
              else check.worst(check.rel_gap(got[n_init:, None],
                                             want[n_init:, None], (1,)))
              if want.shape[-1] > n_init else 0.0)
        want = costs[i, 0] if bool(valid[i]) else torch.full_like(
            costs[i, 0], float("nan"))
        got = o["costs"]
        k = min(got.shape[-1], want.shape[-1])
        ge = check.worst(check.rel_gap(got[:min(k, n_early), None],
                                       want[:min(k, n_early), None], (1,)))
        gt = (check.worst(check.rel_gap(got[n_early:k, None],
                                        want[n_early:k, None], (1,)))
              if k > n_early else None)
        init_gap.append(gi)
        early.append(ge)
        if gt is not None:
            late.append(gt)
        parted += int(gi > part["init"] or gl > part["init_late"]
                      or ge > part["early"])
        st.per_map.append({"example": list(x["key"]), "init": gi,
                           "init_late": gl, "early": ge, "late": gt,
                           "map": map_gap[-1], "pick": pick_gap[-1]})
    window.setdefault("stderr", []).append(
        f"check: {len(c)} examples, {ties} with SPA's picks near-tied left "
        "out of the trajectory's numbers, "
        f"{int(followed.sum())} with SPA's start at the program's tied picks")
    return {"init_gap": check.percentile(init_gap, 50),
            "early_cost_gap": check.percentile(early, 50),
            "late_cost_gap": check.percentile(late, 50),
            "parted": float(parted),
            "iters_gap": max(off, default=float("inf")),
            "map_gap": check.worst(map_gap),
            "pick_gap": check.worst(pick_gap)}
