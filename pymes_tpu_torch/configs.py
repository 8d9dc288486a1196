"""Typed solver/model configurations.

Counterpart of ``pymes_tpu/configs.py`` with the same dataclasses, fields
and defaults, so ``GroundStateConfig(**to_dict(jax_cfg))`` rebuilds a JAX
package configuration here.  Each ``make*`` builds the port's solver on
``device`` (keyword-only), the card unless the caller asks for the CPU;
without a card, :func:`pymes_tpu_torch.config.resolve_device` raises.  As
in the JAX package, ``GroundStateConfig.mixed_precision`` is carried and
not applied by ``make_ccd``/``make_ccsd``: the caller hands it to
``solve`` (the
precision modes are arguments of ``CCD.solve``/``CCSD.solve`` and
attributes of the EOM and FEAST/RT solvers, ``precision`` and
``ls_precision``).
"""

from dataclasses import asdict, dataclass


@dataclass
class GroundStateConfig:
    """CCD/DCD/drCCD/CCSD/DCSD amplitude-equation settings."""

    no: int = 0
    delta_e: float = 1e-8
    max_iter: int = 50
    level_shift: float = 0.0
    is_diis: bool = True
    diis_dim: int = 6
    is_dcd: bool = False          # distinguishable-cluster approximation
    is_dr_ccd: bool = False       # direct-ring (dRPA) channel only
    is_bruekner: bool = False     # quasi-particle energy updates
    mixed_precision: bool = False  # f32 bulk + f64 polish schedule
    log_iterations: bool = False

    def _finish(self, s):
        s.max_iter = self.max_iter
        s.dim_space = self.diis_dim
        s.log_iterations = self.log_iterations
        return s

    def make_ccd(self, *, device=None):
        from pymes_tpu_torch.solver.ccd import CCD

        return self._finish(CCD(self.no, delta_e=self.delta_e,
                                is_dcd=self.is_dcd, is_diis=self.is_diis,
                                is_dr_ccd=self.is_dr_ccd,
                                is_bruekner=self.is_bruekner, device=device))

    def make_ccsd(self, *, device=None):
        from pymes_tpu_torch.solver.ccsd import CCSD

        return self._finish(CCSD(self.no, is_diis=self.is_diis,
                                 delta_e=self.delta_e, is_dcsd=self.is_dcd,
                                 device=device))


@dataclass
class EOMConfig:
    """Davidson EOM-CCSD settings."""

    no: int = 0
    n_excit: int = 3
    max_iter: int = 500
    e_epsilon: float = 1e-8
    max_dim_factor: int = 4

    def make(self, *, device=None):
        from pymes_tpu_torch.solver.eom_ccsd import EOM_CCSD

        s = EOM_CCSD(self.no, n_excit=self.n_excit, device=device)
        s.max_iter = self.max_iter
        s.e_epsilon = self.e_epsilon
        s.max_dim = self.n_excit * self.max_dim_factor
        return s


@dataclass
class FEASTConfig:
    """FEAST contour-filter settings."""

    no: int = 0
    e_c: float = 0.0
    e_r: float = 1.0
    n_trial: int = 5
    n_quad: int = 8
    max_iter: int = 20
    tol: float = 1e-12
    ls_max_iter: int = 20
    seed: int = None

    def make(self, *, device=None):
        from pymes_tpu_torch.solver.feast_eom_ccsd import FEAST_EOM_CCSD

        s = FEAST_EOM_CCSD(self.no, e_c=self.e_c, e_r=self.e_r,
                           n_trial=self.n_trial, max_iter=self.max_iter,
                           tol=self.tol, n_quad=self.n_quad, seed=self.seed,
                           device=device)
        s.ls_max_iter = self.ls_max_iter
        return s


@dataclass
class RTConfig:
    """CIF real-time propagation settings."""

    no: int = 0
    e_c: float = 0.0
    e_r: float = 1.0
    dt: float = 0.1
    n_quad: int = 16
    ls_max_iter: int = 100

    def make(self, *, device=None):
        from pymes_tpu_torch.solver.rt_eom_ccsd import RT_EOM_CCSD

        s = RT_EOM_CCSD(self.no, e_c=self.e_c, e_r=self.e_r, dt=self.dt,
                        n_quad=self.n_quad, device=device)
        s.ls_max_iter = self.ls_max_iter
        return s


@dataclass
class UEGConfig:
    """Uniform electron gas model settings (the model is host numpy, so
    ``make`` takes no device)."""

    n_ele: int = 14
    rs: float = 1.0
    cutoff: float = 2.0
    k_shift: tuple = (0.0, 0.0, 0.0)
    correlator: str = None        # name of a UEG correlator method
    gamma: float = None
    k_cutoff: float = None

    def make(self):
        from pymes_tpu_torch.models.ueg import UEG

        u = UEG(self.n_ele, self.n_ele // 2, self.n_ele // 2, self.rs)
        u.init_single_basis(self.cutoff, list(self.k_shift))
        u.gamma = self.gamma
        u.k_cutoff = self.k_cutoff
        if self.correlator is not None:
            u.correlator = getattr(u, self.correlator)
        return u


def to_dict(cfg):
    return asdict(cfg)
