"""Problem-instance containers and the ``.mat`` fixture loader.

Port of ``quantized_spectrum_cartography_tpu/data/fixtures.py``.  The
reference's runnable data is `qmc/onebitdata1.mat` (saved by
`qmc/generate_test_data.m:78-80`), loaded with scipy and the MATLAB -> C
permutes of `qmc/qmc_utils.py:12-20` and `qmc/qmc.ipynb` cell 1; the loader
applies exactly those permutes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

REFERENCE_FIXTURE = "/root/reference/qmc/onebitdata1.mat"


@dataclasses.dataclass
class Problem:
    """One spectrum-cartography problem instance:

    T_true  [K, I, J]   ground-truth map
    S_true  [R, I, J]   true spatial loss fields
    C_true  [R, K]      true PSDs
    T_1bit  [K, I, J]   +-1 thresholded map (generate_test_data.m:65-66)
    Om      [I, J]      per-location sampling mask (bool), or None
    peaks   [R, 2]      (x, y) true emitter locations, or None
    """

    T_true: torch.Tensor
    S_true: torch.Tensor
    C_true: torch.Tensor
    T_1bit: Optional[torch.Tensor] = None
    Om: Optional[torch.Tensor] = None
    mean_slf: float = 0.0045
    peaks: Optional[torch.Tensor] = None

    @property
    def shape(self):
        K, I, J = self.T_true.shape
        R = self.S_true.shape[0]
        return R, I, J, K


def load_onebit_fixture(path: str = REFERENCE_FIXTURE,
                        device="cuda") -> Problem:
    """Load onebitdata1.mat with the reference's permutes applied, as
    float32 (Om bool) tensors on `device`.

    MATLAB layouts: T (I,J,K), S_true (I,J,R), C_true (K,R), Om (I,J);
    after qmc.ipynb cell 1: T (K,I,J), S (R,I,J), C (R,K).  The file does
    not store the emitters' locations (peaks is None)."""
    import scipy.io as sio

    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found; generate an equivalent instance with "
            "physics.simulator.generate_onebit_problem instead.")
    data = sio.loadmat(path)

    def tensor(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(
            device)

    return Problem(T_true=tensor(np.transpose(data["T_true"], (2, 0, 1))),
                   S_true=tensor(np.transpose(data["S_true"], (2, 0, 1))),
                   C_true=tensor(np.transpose(data["C_true"], (1, 0))),
                   T_1bit=tensor(np.transpose(data["T"], (2, 0, 1))),
                   Om=tensor(data["Om"], bool))
