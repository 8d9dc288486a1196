"""The identity the shared tail kernel rests on: K2′/K3′ over an empty T1
segment do exactly what K2/K3 do.

``csrc/cc_tail.cu`` serves CCD as the case N1 = 0 of its passes over
[T1 | T2], so the CCD wrappers (``kernels/ccd_tail.py``) call the CCSD
entries without a T1 segment.  Here, on the CPU, the CCD twins and the
CCSD twins given ``R1 = T1 = F1 = None`` must agree bit for bit: the rings,
the Gram row, the mixed T and the energies (the one-body piece 0), over
slots that wrap the ring, part-filled rings, a ring of 17 slots (three Gram
groups on the card), three level shifts, in f64 and f32.  The kernels
themselves are held to these twins on the card (``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from pymes_tpu_torch.kernels import ccd_tail, ccsd_tail

NO, NV = 3, 5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shift", [0.0, -1.0, 0.37])
@pytest.mark.parametrize("m,slot,n_valid", [(1, 0, 1), (6, 0, 1), (6, 3, 4),
                                            (6, 2, 6), (17, 16, 17)])
def test_ccd_twins_equal_ccsd_twins_without_t1(dtype, shift, m, slot,
                                               n_valid):
    rng = np.random.default_rng(31 * m + slot)
    shape, n = (NO, NO, NV, NV), NO * NO * NV * NV

    def t(*s, scale=1.0):
        return torch.as_tensor(rng.standard_normal(s) * scale, dtype=dtype)

    R, T, V = t(*shape, scale=0.1), t(*shape), t(*shape)
    Vx = V.transpose(2, 3).contiguous()
    eps = np.sort(rng.standard_normal(NO + NV))
    eps_i = torch.as_tensor(eps[:NO] - 1.0, dtype=dtype)
    eps_a = torch.as_tensor(eps[NO:] + 1.0, dtype=dtype)
    ring = (t(m, n), t(m, n))
    coeff = t(m)
    rings = [tuple(r.clone() for r in ring) for _ in range(2)]
    row_d = ccd_tail.jacobi_diis_insert(R, T, eps_i, eps_a, shift,
                                        *rings[0], slot, n_valid)
    row_s = ccsd_tail.jacobi_diis_insert(None, None, R, T, eps_i, eps_a,
                                         shift, *rings[1], slot, n_valid)
    assert row_d.dtype == dtype
    assert torch.equal(row_d, row_s)
    assert bool((row_d[n_valid:] == 0).all())
    for a, b in zip(*rings):
        assert torch.equal(a, b)
    Ts = [torch.zeros(shape, dtype=dtype) for _ in range(2)]
    e_d = ccd_tail.diis_mix_energy(rings[0][1], coeff, n_valid, Ts[0], V,
                                   Vx)
    e_s = ccsd_tail.diis_mix_energy(rings[1][1], coeff, n_valid, None,
                                    Ts[1], None, V, Vx)
    assert torch.equal(Ts[0], Ts[1])
    assert float(e_s[0]) == 0.0
    assert torch.equal(e_d[0], e_s[1]) and torch.equal(e_d[1], e_s[2])
