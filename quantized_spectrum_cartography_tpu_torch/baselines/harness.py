"""Evaluation harness: the `joint_opt_ae.m` comparison protocol.

Port of ``quantized_spectrum_cartography_tpu/baselines/harness.py`` (the
MATLAB comparison harness, `backup/algorithms/joint_opt_ae.m`):

- the condition grid: the reference's five sweep axes (`:11-25`), each
  varied around the base configuration (R=2, shadow 5, Xc 50, f 0.05, sinc
  basis, separable, noiseless — `:12-28`);
- the example pipeline (`:118-180`): a sinc-basis map, optional additive
  uniform noise at the requested SNR (`:137-147`), negatives clamped,
  per-location sampling Omega = randperm(IJ, round(f*IJ)) (`:169-173`);
- the metrics (`:1019-1035`): SRE, the harness NAE (global-sum
  normalization, 1/R) after factor-permutation matching (cpderr's role,
  `:213-246`), BTD's validity filter SRE < 3 (`:496-501`), and the miss /
  false-detection counts at the true emitter peaks with the (total+1)
  denominators (`:48-49`, `:514-554`);
- the five published methods (figure at `:570-655`): TPS, BTD/LL1,
  DeepComp, Nasdac, DowJons.

The port carries a leading batch axis through every method instead of
vmapping single-example solvers: a method is fn(generator, problem) on a
`HarnessProblem` of B examples and returns batched tensors; `run_conditions`
calls it with B=1, `BatchedHarness` with all of a condition's examples.
Random streams: the examples of condition ci come from one
torch.Generator seeded with seed*100_000 + ci*1_000 (in `run_conditions`,
+ the example's index, one example at a time), and each method draws from
its own generator seeded from that number and zlib.crc32 of its name.
They cannot equal the JAX package's jax.random streams, so the two agree
in distribution, not example by example.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.ops.metrics import (
    detection_counts,
    nae,
    nae_tensor,
    sre,
)
from quantized_spectrum_cartography_tpu_torch.physics import (
    generate_map_batch,
    generate_onebit_problem,
)
from quantized_spectrum_cartography_tpu_torch.physics.shadowing import (
    correlation_cholesky,
)

_MAP = (-3, -2, -1)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def best_permutation(S_hat, S_true) -> np.ndarray:
    """Optimal factor matching (tensorlab `cpderr`'s permutation fixing,
    joint_opt_ae.m:213-246): the order of S_hat's rows that best matches
    S_true's rows by normalized correlation, by the Hungarian algorithm
    (globally optimal; greedy matching can miss at the R axis' R=13), on
    the host with scipy."""
    from scipy.optimize import linear_sum_assignment

    A = _np(S_hat).reshape(S_hat.shape[0], -1)
    B = _np(S_true).reshape(S_true.shape[0], -1)
    A = A / np.maximum(np.linalg.norm(A, axis=1, keepdims=True), 1e-12)
    B = B / np.maximum(np.linalg.norm(B, axis=1, keepdims=True), 1e-12)
    rows, cols = linear_sum_assignment(-(A @ B.T))   # maximize correlation
    perm = np.empty(B.shape[0], dtype=np.int64)
    perm[cols] = rows
    return perm


@dataclasses.dataclass
class MethodResult:
    sre_map: float
    nae_s: List[float]
    nae_c: List[float]
    detected: List[bool]


def evaluate_method(
    T_hat: torch.Tensor,
    T_true: torch.Tensor,
    S_hat: Optional[torch.Tensor] = None,
    C_hat: Optional[torch.Tensor] = None,
    S_true: Optional[torch.Tensor] = None,
    C_true: Optional[torch.Tensor] = None,
    peaks: Optional[torch.Tensor] = None,
) -> MethodResult:
    """Metrics of one recovery (joint_opt_ae.m:1019-1035, 514-544).
    `detected` is per emitter over all bands: detected when its per-band
    miss rate under the reference protocol is below 1/2."""
    sre_map = float(sre(T_hat, T_true))
    nae_s, nae_c, detected = [], [], []
    if S_hat is not None and S_true is not None:
        perm = torch.as_tensor(best_permutation(S_hat, S_true),
                               device=S_hat.device)
        S_hat = S_hat[perm]
        if C_hat is not None:
            C_hat = C_hat[perm]
        for r in range(S_true.shape[0]):
            nae_s.append(float(nae(S_hat[r], S_true[r])))
            if C_hat is not None and C_true is not None:
                nae_c.append(float(nae(C_hat[r], C_true[r])))
        if peaks is not None:
            for r in range(S_true.shape[0]):
                m, p, _, _ = detection_counts(T_hat, T_true, peaks[r:r + 1])
                detected.append(bool(int(p) > 0 and int(m) <= int(p) // 2))
    return MethodResult(sre_map=sre_map, nae_s=nae_s, nae_c=nae_c,
                        detected=detected)


# --------------------------------------------------------------------------
# condition grid
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Condition:
    """One harness condition — the reference base values at
    joint_opt_ae.m:12-28 (R=2, shadow_sigma=5, Xc=50, f=0.05, no noise)."""

    fraction: float = 0.05
    num_emitters: int = 2
    shadow_sigma: float = 5.0
    xc: float = 50.0
    snr: Optional[float] = None        # dB; None = noiseless (use_snr=false)

    def label(self) -> str:
        return (f"f={self.fraction} R={self.num_emitters} "
                f"sig={self.shadow_sigma} Xc={self.xc} snr={self.snr}")


# the reference's sweep axes (joint_opt_ae.m:11-25)
REFERENCE_AXES: Dict[str, Sequence] = {
    "fraction": (0.01, 0.05, 0.1, 0.15, 0.2),
    "num_emitters": (5, 7, 9, 11, 13),
    "shadow_sigma": (4, 5, 6, 7, 8),
    "xc": (10, 30, 50, 70, 90),
    "snr": (0, 10, 20, 30, 40),
}


def condition_grid(
    axis: Optional[str] = None,
    values: Optional[Sequence] = None,
    base: Condition = Condition(),
) -> tuple:
    """Conditions varying one axis around `base` (the reference sweeps one
    variable per run, `:82-87`); with no axis, the base condition alone."""
    if axis is None:
        return (base,)
    vals = values if values is not None else REFERENCE_AXES[axis]
    return tuple(dataclasses.replace(base, **{axis: v}) for v in vals)


@dataclasses.dataclass
class HarnessProblem:
    """A batch of B generated examples with their sampling patterns."""

    T_true: torch.Tensor       # [B, K, I, J] ground truth
    T_noisy: torch.Tensor      # [B, K, I, J] after SNR noise + clamp
    S_true: torch.Tensor       # [B, R, I, J]
    C_true: torch.Tensor       # [B, R, K]
    peaks: torch.Tensor        # [B, R, 2] (x, y)
    Om: torch.Tensor           # [B, I, J] bool per-location mask
    sample_idx: Optional[torch.Tensor]   # [B, N, 2] (row, col), row-major
    fraction: float

    @property
    def T_obs(self) -> torch.Tensor:
        """Masked observations (zeros at unobserved locations)."""
        return self.T_noisy * self.Om.to(self.T_noisy.dtype)[..., None, :, :]


def problem_from_draws(
    T_map: torch.Tensor,
    S: torch.Tensor,
    C: torch.Tensor,
    peaks: torch.Tensor,
    cond: Condition,
    noise: Optional[torch.Tensor],
    perm: torch.Tensor,
) -> HarnessProblem:
    """Examples from their draws (joint_opt_ae.m:118-180): maps T_map
    [..., K, I, J] with factors and peaks, clamped at 0; with an SNR, the
    uniform draws `noise` (T_map's shape) scaled as `T + sn*1.73*rand` (sn
    from the SNR, zeroed when sn >= 100) and clamped again; the observed
    locations perm[..., :round(f*IJ)] of a permutation perm [..., IJ] of
    the grid."""
    T_true = T_map.clamp_min(0.0)
    if cond.snr is not None:
        Ps = T_true.square().sum(_MAP, keepdim=True)
        Pn = Ps * 10.0 ** (-cond.snr / 10.0)
        sn = torch.sqrt(Pn / (T_true.shape[-3] * T_true.shape[-2]
                              * T_true.shape[-1]))
        sn = torch.where(sn >= 1e2, 0.0, sn)
        T = (T_true + sn * 1.73 * noise).clamp_min(0.0)
    else:
        T = T_true
    I, J = T_true.shape[-2:]
    num = int(round(cond.fraction * I * J))
    flat = torch.sort(perm[..., :num], dim=-1).values
    Om = torch.zeros(*perm.shape, dtype=torch.bool, device=perm.device)
    Om = Om.scatter(-1, flat, True).reshape(*perm.shape[:-1], I, J)
    sample_idx = torch.stack([flat // J, flat % J], dim=-1)
    return HarnessProblem(T_true=T_true, T_noisy=T, S_true=S, C_true=C,
                          peaks=peaks, Om=Om, sample_idx=sample_idx,
                          fraction=cond.fraction)


def make_problem(
    generator: torch.Generator,
    cond: Condition,
    physics: PhysicsConfig = PhysicsConfig(),
    batch: int = 1,
    device="cuda",
    chol: Optional[torch.Tensor] = None,
) -> HarnessProblem:
    """`batch` examples of condition `cond` from `generator` (on `device`):
    the maps (`physics.generate_map_batch` at the condition's R, shadowing,
    Xc, sinc basis), the SNR noise, and a uniform permutation of the grid
    per example; `chol` is the shadowing's Cholesky factor when cached."""
    pcfg = dataclasses.replace(
        physics, num_emitters=cond.num_emitters,
        shadow_sigma=float(cond.shadow_sigma),
        decorrelation_distance=float(cond.xc), psd_basis="s",
        separable=True)
    T, S, C, peaks = generate_map_batch(generator, pcfg, batch, device, chol)
    noise = (torch.rand(T.shape, generator=generator, device=device)
             if cond.snr is not None else None)
    IJ = pcfg.grid_size * pcfg.grid_size
    perm = torch.argsort(torch.rand(batch, IJ, generator=generator,
                                    device=device), dim=-1)
    return problem_from_draws(T, S, C, peaks, cond, noise, perm)


# --------------------------------------------------------------------------
# condition runners
# --------------------------------------------------------------------------

HarnessFn = Callable[..., Dict[str, torch.Tensor]]
# signature: (generator, problem) -> {"T_hat": ..., optional "S_hat",
# "C_hat"}, each with the problem's leading batch axis

# the reference keeps a BTD example only when its SRE < 3
# (joint_opt_ae.m:496-501 count_valid)
DEFAULT_VALIDITY_CAPS = {"btd": 3.0}

# methods that read HarnessProblem.sample_idx; the others see None there
SAMPLE_IDX_METHODS = frozenset({"tps"})


def _method_generator(device, base: int, name: str) -> torch.Generator:
    """The method's own stream: seeded from the examples' seed `base` and
    zlib.crc32 of its name (stable across processes, unlike hash())."""
    seed = ((base << 32) + zlib.crc32(name.encode())) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(seed)


def _run(fn: HarnessFn, generator, hp: HarnessProblem):
    with torch.no_grad():
        out = fn(generator, hp)
    return {k: v for k, v in out.items() if v is not None}


def run_conditions(
    methods: Dict[str, HarnessFn],
    conditions: Sequence[Condition],
    num_examples: int = 1,
    physics: PhysicsConfig = PhysicsConfig(),
    seed: int = 0,
    validity_caps: Optional[Dict[str, float]] = None,
    log_fn=None,
    device="cuda",
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Monte-Carlo sweep over `conditions` (joint_opt_ae.m:82-117), one
    example at a time.

    Returns results[condition.label()][method] = {sre, nae_s, nae_c,
    miss_prob, false_prob, valid} with the reference's accumulation rules:
    per-condition means over the (valid) examples, detection probabilities
    as event_count / (total + 1)."""
    caps = DEFAULT_VALIDITY_CAPS if validity_caps is None else validity_caps
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for ci, cond in enumerate(conditions):
        acc = {m: {"sre": [], "nae_s": [], "nae_c": [],
                   "miss": 0, "peaks": 0, "false": 0, "lows": 0}
               for m in methods}
        for ex in range(num_examples):
            base = seed * 100_000 + ci * 1_000 + ex
            gen = torch.Generator(device=device).manual_seed(base)
            hp = make_problem(gen, cond, physics, 1, device)
            for name, fn in methods.items():
                res = _run(fn, _method_generator(device, base, name), hp)
                T_hat = res["T_hat"][0]
                s = float(sre(T_hat, hp.T_true[0]))
                cap = caps.get(name)
                if cap is not None and s >= cap:
                    continue                      # invalid example (BTD rule)
                a = acc[name]
                a["sre"].append(s)
                if "S_hat" in res:
                    S_true, R = hp.S_true[0], hp.S_true.shape[1]
                    perm = torch.as_tensor(
                        best_permutation(res["S_hat"][0], S_true),
                        device=T_hat.device)
                    a["nae_s"].append(float(nae_tensor(
                        res["S_hat"][0][perm], S_true, R)))
                    if "C_hat" in res:
                        a["nae_c"].append(float(nae_tensor(
                            res["C_hat"][0][perm], hp.C_true[0], R)))
                m_, p_, f_, l_ = detection_counts(T_hat, hp.T_noisy[0],
                                                  hp.peaks[0])
                a["miss"] += int(m_)
                a["peaks"] += int(p_)
                a["false"] += int(f_)
                a["lows"] += int(l_)
                if log_fn:
                    log_fn(f"{cond.label()} ex{ex} {name}: sre {s:.4f}")
        out[cond.label()] = {}
        for name in methods:
            a = acc[name]
            out[cond.label()][name] = {
                "sre": float(np.mean(a["sre"])) if a["sre"] else float("nan"),
                "nae_s": (float(np.mean(a["nae_s"]))
                          if a["nae_s"] else float("nan")),
                "nae_c": (float(np.mean(a["nae_c"]))
                          if a["nae_c"] else float("nan")),
                # reference denominators: (total+1), joint_opt_ae.m:549-554
                "miss_prob": a["miss"] / (a["peaks"] + 1),
                "false_prob": a["false"] / (a["lows"] + 1),
                "valid": len(a["sre"]),
            }
    return out


class BatchedHarness:
    """The condition-grid runner with all of a condition's examples in one
    batch per method.

    Per condition: the examples are drawn as one batch (the shadowing's
    Cholesky factor cached per (grid, Xc)), each method runs once on the
    whole batch, SRE and the detection events are counted on the device,
    and the permutation matching and NAE run in numpy on the host after one
    transfer per (condition, method).  The rules (validity caps, detection
    events, (total+1) denominators) are `run_conditions`'s; the random
    streams differ from it (see the module docstring).  `seconds` holds
    each (condition label, method)'s seconds, the device synchronized.
    Reference: `joint_opt_ae.m:82-117` (condition loop), `:118-180`
    (examples), `:496-501` (BTD validity), `:514-554` (detection)."""

    def __init__(
        self,
        methods: Dict[str, HarnessFn],
        physics: PhysicsConfig = PhysicsConfig(),
        validity_caps: Optional[Dict[str, float]] = None,
        log_fn=None,
        device="cuda",
    ):
        self.methods = methods
        self.physics = physics
        self.caps = (DEFAULT_VALIDITY_CAPS if validity_caps is None
                     else validity_caps)
        self.log = log_fn or (lambda *a: None)
        self.device = device
        self.seconds: Dict[str, Dict[str, float]] = {}
        self._chol: Dict[float, torch.Tensor] = {}

    def _cholesky(self, xc: float) -> torch.Tensor:
        if xc not in self._chol:
            self._chol[xc] = torch.as_tensor(correlation_cholesky(
                self.physics.grid_size, float(xc)), device=self.device)
        return self._chol[xc]

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(
        self,
        conditions: Sequence[Condition],
        num_examples: int,
        seed: int = 0,
    ) -> Dict[str, Dict[str, Dict[str, float]]]:
        """`run_conditions`'s result structure, plus the raw detection event
        counts (miss_count / peak_count / false_count / low_count), the
        per-example SREs (sre_all), and the per-example events before the
        validity cap (miss_all / peak_all / false_all / low_all, with the
        validity flags valid_all): the counts are their sums over the valid
        examples."""
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for ci, cond in enumerate(conditions):
            base = seed * 100_000 + ci * 1_000
            gen = torch.Generator(device=self.device).manual_seed(base)
            hp = make_problem(gen, cond, self.physics, num_examples,
                              self.device, self._cholesky(cond.xc))
            label = cond.label()
            out[label], self.seconds[label] = {}, {}
            for name, fn in self.methods.items():
                self._sync()
                t0 = time.perf_counter()
                mhp = (hp if name in SAMPLE_IDX_METHODS
                       else dataclasses.replace(hp, sample_idx=None))
                res = _run(fn, _method_generator(self.device, base, name), mhp)
                s = sre(res["T_hat"], hp.T_true, dim=_MAP)
                counts = detection_counts(res["T_hat"], hp.T_noisy, hp.peaks)
                st = self._accumulate(name, cond, res, {
                    "S_true": hp.S_true, "C_true": hp.C_true}, _np(s),
                    *(_np(c) for c in counts))
                self._sync()
                self.seconds[label][name] = time.perf_counter() - t0
                out[label][name] = st
                self.log(f"{label} {name}: sre {st['sre']:.4f} "
                         f"({st['valid']} valid)")
        return out

    def _accumulate(self, name, cond, res, arrs, s, m_, p_, f_, l_):
        """Host-side aggregation with the reference accumulation rules."""
        cap = self.caps.get(name)
        valid = np.ones(s.shape[0], bool) if cap is None else (s < cap)
        nae_s_list: List[float] = []
        nae_c_list: List[float] = []
        if "S_hat" in res:
            S_hat_all = _np(res["S_hat"])
            S_true_all = _np(arrs["S_true"])
            C_hat_all = _np(res["C_hat"]) if "C_hat" in res else None
            C_true_all = _np(arrs["C_true"])
            R = S_true_all.shape[1]
            for b in range(s.shape[0]):
                if not valid[b]:
                    continue
                perm = best_permutation(S_hat_all[b], S_true_all[b])
                nae_s_list.append(
                    _nae_tensor_np(S_hat_all[b][perm], S_true_all[b], R))
                if C_hat_all is not None:
                    nae_c_list.append(_nae_tensor_np(
                        C_hat_all[b][perm], C_true_all[b], R))
        miss = int(m_[valid].sum())
        peaks_n = int(p_[valid].sum())
        false = int(f_[valid].sum())
        lows = int(l_[valid].sum())
        sre_valid = s[valid]
        per_example = {f"{k}_all": [int(x) for x in v] for k, v in
                       (("miss", m_), ("peak", p_), ("false", f_),
                        ("low", l_))}
        return {
            "sre": float(sre_valid.mean()) if sre_valid.size else float("nan"),
            "nae_s": (float(np.mean(nae_s_list)) if nae_s_list
                      else float("nan")),
            "nae_c": (float(np.mean(nae_c_list)) if nae_c_list
                      else float("nan")),
            # reference denominators: (total+1), joint_opt_ae.m:549-554
            "miss_prob": miss / (peaks_n + 1),
            "false_prob": false / (lows + 1),
            "miss_count": miss, "peak_count": peaks_n,
            "false_count": false, "low_count": lows,
            "valid": int(valid.sum()),
            "sre_all": [float(x) for x in s],
            **per_example,
            "valid_all": [bool(v) for v in valid],
        }


def _nae_tensor_np(X_hat: np.ndarray, X_true: np.ndarray, R: int) -> float:
    """numpy twin of ops.metrics.nae_tensor (joint_opt_ae.m:1014-1016)."""
    a = X_hat / max(np.sum(np.abs(X_hat)), 1e-12)
    b = X_true / max(np.sum(np.abs(X_true)), 1e-12)
    return float(np.sum(np.abs(a - b)) / R)


def run_conditions_batched(
    methods: Dict[str, HarnessFn],
    conditions: Sequence[Condition],
    num_examples: int = 10,
    physics: PhysicsConfig = PhysicsConfig(),
    seed: int = 0,
    validity_caps: Optional[Dict[str, float]] = None,
    log_fn=None,
    device="cuda",
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """One-shot convenience wrapper over `BatchedHarness.run`."""
    return BatchedHarness(methods, physics, validity_caps, log_fn,
                          device).run(conditions, num_examples, seed)


# --------------------------------------------------------------------------
# the five published methods (joint_opt_ae.m figure :570-655)
# --------------------------------------------------------------------------

def _where(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """a where the per-problem flag [B] holds, else b."""
    return torch.where(flag.reshape(*flag.shape, *(1,) * (a.ndim - flag.ndim)),
                       a, b)


def standard_methods(
    gen_apply: Optional[Callable] = None,
    z_dim: int = 64,
    ae_complete: Optional[Callable] = None,
    btd_restarts: int = 8,
    dowjons_iters: int = 30,
    dowjons_restarts: int = 4,
    ae_input_apply: Optional[Callable] = None,
    ae_latent_fns: Optional[tuple] = None,
    dowjons_variant: str = "gan",
    anchor_mu0: float = 0.3,
    peak_refine: int = 2,
    backstop_frac: float = 0.5,
    polish_ridge: float = 0.1,
    polish_gamma: float = 0.75,
    polish_peaks_extra: int = 2,
    polish_floor: float = 0.0,
    anchor_conf_tau: float = 0.0,
    polish_mode: str = "blend",
) -> Dict[str, HarnessFn]:
    """Method registry.  `gen_apply` (the deep generative prior) enables
    DowJons; `ae_complete(mask, maps) -> maps` (the trained completion AE,
    training.ae_trainer.make_ae_completer) enables DeepComp and Nasdac;
    `ae_input_apply` (training.ae_trainer.make_ae_input_fn) enables
    DowJons-AE and `ae_latent_fns` DowJons-AE-latent.  TPS and BTD need no
    trained model.  The methods with random starts (btd, the dowjons
    variants on gen_apply) take their standard normals as `draws=` (see
    `btd_ll1`, `recover_dowjons_unquantized`) instead of the generator
    when given.  "dowjons" is the `dowjons_variant` ('gan' by default),
    popped from its own key so a full registry runs it once."""
    from quantized_spectrum_cartography_tpu_torch.baselines.btd import btd_ll1
    from quantized_spectrum_cartography_tpu_torch.baselines.spa import nmf_spa
    from quantized_spectrum_cartography_tpu_torch.baselines.tps import (
        tps_complete)
    from quantized_spectrum_cartography_tpu_torch.solvers.completion import (
        recover_dowjons_ae,
        recover_dowjons_ae_latent,
        recover_dowjons_unquantized,
        residual_peak_refine,
    )
    from quantized_spectrum_cartography_tpu_torch.solvers.nasdac import (
        recover_nasdac,
        witnessed_swap_flag,
    )

    methods: Dict[str, HarnessFn] = {}

    def mask(hp):
        return hp.Om.to(hp.T_noisy.dtype)

    def refine(T_hat, hp):
        if not peak_refine:
            return T_hat
        # the patch budget scales with R; inert where the model already fits
        return residual_peak_refine(
            T_hat, hp.T_obs, mask(hp),
            num_patches=max(peak_refine, hp.S_true.shape[-3] // 2))

    def tps_fn(generator, hp):
        return {"T_hat": tps_complete(hp.T_obs, hp.Om, hp.sample_idx)}

    methods["tps"] = tps_fn

    def btd_fn(generator, hp, draws=None):
        W = torch.broadcast_to(mask(hp)[..., None, :, :], hp.T_obs.shape)
        S, C, T_hat = btd_ll1(hp.T_obs, hp.S_true.shape[-3], L=5, iters=50,
                              mask=W, generator=generator,
                              restarts=btd_restarts, draws=draws)
        return {"T_hat": T_hat, "S_hat": S, "C_hat": C}

    methods["btd"] = btd_fn

    def nasdac_solve(hp):
        # Completion-witnessed anchor selection: the plain AND the anchored
        # solve; the plain one is kept unless it extinguishes a
        # completion-witnessed peak (solvers.nasdac.witnessed_swap_flag),
        # then the residual peak patches.  The completion of every band
        # is computed once and shared.
        R, W = hp.S_true.shape[-3], mask(hp)
        T_comp = ae_complete(W[..., None, :, :], hp.T_obs)
        plain = recover_nasdac(hp.T_obs, hp.Om, ae_complete, num_emitters=R,
                               anchor_mu0=0.0)
        anch = recover_nasdac(hp.T_obs, hp.Om, ae_complete, num_emitters=R,
                              anchor_mu0=anchor_mu0, anchor_rho0=1.0,
                              polish_ridge=polish_ridge,
                              polish_gamma=polish_gamma,
                              polish_peaks_extra=polish_peaks_extra,
                              polish_floor=polish_floor,
                              anchor_conf_tau=anchor_conf_tau,
                              polish_mode=polish_mode, T_comp=T_comp)
        flag = witnessed_swap_flag(plain.T_hat, anch.T_hat, T_comp, hp.T_obs,
                                   W, R + 2)
        T_hat = refine(_where(flag, anch.T_hat, plain.T_hat), hp)
        return (T_hat, _where(flag, anch.S, plain.S),
                _where(flag, anch.C, plain.C))

    def backstop(T_hat, hp):
        # no-extinguish backstop: wherever the joint estimate falls below
        # backstop_frac of the Nasdac-stage estimate, keep the latter
        T_nas, _, _ = nasdac_solve(hp)
        return refine(torch.where(T_hat < backstop_frac * T_nas, T_nas,
                                  T_hat), hp)

    if ae_complete is not None:
        def deepcomp_fn(generator, hp):
            # DeepComp (`deep_comp.py:21-42`): one-shot AE completion of
            # every band's masked map; no factorization
            return {"T_hat": ae_complete(mask(hp)[..., None, :, :],
                                         hp.T_obs)}

        methods["deepcomp"] = deepcomp_fn

        def nasdac_fn(generator, hp):
            T_hat, S, C = nasdac_solve(hp)
            return {"T_hat": T_hat, "S_hat": S, "C_hat": C}

        methods["nasdac"] = nasdac_fn

    if gen_apply is not None:
        def dowjons_gan_fn(generator, hp, draws=None):
            # SPA-informed latent init (joint_opt_ae.m:301-317): the SPA
            # columns, completed at their raw amplitude by the AE when it
            # is there (dense init), else the masked raw SPA columns
            R, W = hp.S_true.shape[-3], mask(hp)
            I, J = hp.T_obs.shape[-2:]
            _, S_flat = nmf_spa(hp.T_obs.flatten(-2), R)
            S_init = S_flat.reshape(*hp.T_obs.shape[:-3], R, I, J)
            dense = ae_complete is not None
            if dense:
                S_init = ae_complete(W[..., None, :, :], S_init)
            plain = recover_dowjons_unquantized(
                hp.T_obs, hp.Om, gen_apply, num_emitters=R, z_dim=z_dim,
                outer_iters=dowjons_iters, S_init=S_init,
                n_restarts=dowjons_restarts, S_init_dense=dense,
                generator=generator, draws=draws)
            T_hat = backstop(plain.T_hat, hp) if dense else plain.T_hat
            return {"T_hat": T_hat, "S_hat": plain.S, "C_hat": plain.C}

        methods["dowjons_gan"] = dowjons_gan_fn

    if ae_input_apply is not None:
        def dowjons_ae_fn(generator, hp):
            res = recover_dowjons_ae(hp.T_obs, hp.Om, ae_input_apply,
                                     num_emitters=hp.S_true.shape[-3],
                                     outer_iters=dowjons_iters)
            return {"T_hat": res.T_hat, "S_hat": res.S, "C_hat": res.C}

        methods["dowjons_ae"] = dowjons_ae_fn

    if ae_latent_fns is not None:
        ae_encode, ae_decode = ae_latent_fns

        def dowjons_ae_latent_fn(generator, hp):
            plain = recover_dowjons_ae_latent(
                hp.T_obs, hp.Om, ae_encode, ae_decode,
                num_emitters=hp.S_true.shape[-3], outer_iters=dowjons_iters)
            T_hat = (plain.T_hat if ae_complete is None
                     else backstop(plain.T_hat, hp))
            return {"T_hat": T_hat, "S_hat": plain.S, "C_hat": plain.C}

        methods["dowjons_ae_latent"] = dowjons_ae_latent_fn

    variant_key = f"dowjons_{dowjons_variant}"
    if variant_key not in methods and "dowjons_gan" in methods:
        variant_key = "dowjons_gan"
    if variant_key in methods:
        methods["dowjons"] = methods.pop(variant_key)
    return methods


# --------------------------------------------------------------------------
# fraction-only sweep (the CLI's `sweep`)
# --------------------------------------------------------------------------

RecoverFn = Callable[..., Dict[str, torch.Tensor]]
# signature: (generator, Problem, sample_fraction) -> {"T_hat": ...,
# optional "S_hat", "C_hat"} for one map


def run_sweep(
    methods: Dict[str, RecoverFn],
    fractions: Sequence[float] = (0.05, 0.1),
    num_examples: int = 5,
    physics: PhysicsConfig = PhysicsConfig(),
    seed: int = 0,
    device="cuda",
) -> Dict[str, Dict[float, Dict[str, float]]]:
    """Fraction-only Monte-Carlo sweep on `generate_onebit_problem` maps
    (example ex drawn from a generator seeded with seed*10_000 + ex).
    Returns results[method][fraction] = {sre, nae_s, nae_c, miss}."""
    out: Dict[str, Dict[float, Dict[str, float]]] = {m: {} for m in methods}
    for f in fractions:
        acc = {m: {"sre": [], "nae_s": [], "nae_c": [], "miss": 0,
                   "peaks": 0} for m in methods}
        for ex in range(num_examples):
            base = seed * 10_000 + ex
            prob = generate_onebit_problem(
                torch.Generator(device=device).manual_seed(base), physics,
                sample_fraction=f, device=device)
            for name, fn in methods.items():
                with torch.no_grad():
                    res = fn(_method_generator(device, base, name), prob, f)
                mr = evaluate_method(
                    res["T_hat"], prob.T_true, S_hat=res.get("S_hat"),
                    C_hat=res.get("C_hat"), S_true=prob.S_true,
                    C_true=prob.C_true)
                a = acc[name]
                a["sre"].append(mr.sre_map)
                a["nae_s"].extend(mr.nae_s)
                a["nae_c"].extend(mr.nae_c)
                if prob.peaks is not None:
                    m_, p_, _, _ = detection_counts(res["T_hat"],
                                                    prob.T_true, prob.peaks)
                    a["miss"] += int(m_)
                    a["peaks"] += int(p_)
        for name in methods:
            a = acc[name]
            out[name][f] = {
                "sre": float(np.mean(a["sre"])) if a["sre"] else float("nan"),
                "nae_s": (float(np.mean(a["nae_s"]))
                          if a["nae_s"] else float("nan")),
                "nae_c": (float(np.mean(a["nae_c"]))
                          if a["nae_c"] else float("nan")),
                "miss": a["miss"] / (a["peaks"] + 1),
            }
    return out
