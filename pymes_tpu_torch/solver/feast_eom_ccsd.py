"""FEAST-EOM-CCSD: contour-integral energy-filtered excited states.

Counterpart of ``pymes_tpu/solver/feast_eom_ccsd.py``, with both of its
linear-solve precisions (``ls_precision``): the spectral projector onto the
window
[e_c − e_r, e_c + e_r] is Gauss-Legendre quadrature of the resolvent over
a half circle, ``Q = −Σ_e w_e/2 · Re[e_r e^{iθ_e} (z_e − H̄)⁻¹ U]``; every
(node, trial) pair is one shifted solve, and the tiny oblique projected
eigenproblem is solved on the host.

A complex system is kept in its real embedding: the unknown is the
(Re x, Im x) pair of length 2N with the real inner product
(``feast_eom_ccsd.py:116-123``).  H̄ is real, so the sigma of a pair is one
batched sigma on its two rows either way; GMRES on the pair builds the JAX
package's Krylov space, so iteration counts and FEAST trajectories can be
held to it; and the kernels stay f64.

All (node, trial) systems of a FEAST iteration are lanes of one
:func:`pymes_tpu_torch.ops.gmres.gmres_lanes` call (chunked only to fit
``krylov_mem_budget_bytes``): each Arnoldi step applies ONE batched sigma
(``_batched_sigma``, the EOM hook) to the (Re, Im) rows of the active
lanes, then kernel K8 (:mod:`pymes_tpu_torch.kernels.shifted`) assembles
M(z − H̄)x, then K7 projects.  The honest residual ‖b − (z − H̄)x‖/‖b‖ of
every lane is one more batched sigma and a K8 pass in residual mode.  The
quadrature sum runs on the card, so only Q (m, N) comes down.  The trial
QR, the SVD truncation and ``scipy.linalg.eig(H_proj, B)`` run on the host.

``node_mesh`` (a :class:`~pymes_tpu_torch.parallel.mesh.Mesh`) fans the
contour nodes out over devices as the JAX package's ``node_mesh`` does
(``feast_eom_ccsd.py:700-710``): each device holds a replica of the
operator (f, V, T2, diag and the H̄ intermediates) and solves the lanes of
its share of the nodes, cut as :func:`pymes_tpu_torch.parallel.sharding.
shard_over_nodes` cuts them; each share's X is gathered back to the
solver's device for the quadrature sum.  Where the node count does not
divide the mesh, every device solves every node on its replica (the
replicated placement of ``shard_over_nodes``) and the first device's X is
taken, so the result is unchanged.  One controller drives the shares in
order (each Arnoldi step reads its Hessenberg column on the host), so on a
repeated device (``devices=["cuda:0"] * 2``) the mesh changes the batching
and the memory, never a result beyond the rounding of the batched sigma.

``ls_precision="mixed"`` is the JAX package's default engine
(``feast_eom_ccsd.py:585-800``): the Krylov solves run in f32 inside an f64
iterative refinement.  The operator is cast to f32 once per operator
(f, every V block, T2, the H̄ intermediates, the diagonal, K1's packed
sector blocks and K4's plan weights; ``_cast_f32`` :250, here
:func:`pymes_tpu_torch.util.precision.cast_f32`), and each pass
solves (z − H̄)dx = r in f32 through the f32 sigma (K1, K4, K5 in f32, its
GEMMs at full f32: TF32 is switched off for the engine's scope and the
caller's settings restored), the f32 lane-batched GMRES (K7 and K8 in f32)
to ``max(ls_conv_tol, 1e-5)``, accumulates x += dx in f64, and takes the
honest residual r = b − (z − H̄)x with the f64 operator (K8 in residual
mode) as the next right-hand side, until every lane of the chunk is at
``ls_conv_tol``, after ``ls_refine_max`` passes, or once the worst lane
contracts by less than half (the stall test, :791-797).  It runs for the
"inhouse", "opt" and "jacobi" backends and without ``node_mesh`` (a
``node_mesh`` takes the f64 path, as in the JAX package).  The unknowns
stay one lane per (node, trial): the JAX mixed path stacks the trials of
one node into one flat GMRES with a shared Krylov polynomial (:170-181)
because its TPU worker crashed on per-lane batching, so where a node has
several trials the refinement-pass counts may differ from the JAX
package's, never the converged result.  The port's default stays "f64"
(the JAX package's is "mixed") until the card has timed both.

Not ported: the ``jsp`` backend (jax.scipy), the compile-watchdog knobs
``max_nodes_per_dispatch`` / ``max_nodes_per_scan`` /
``max_trials_per_batch``, the Ozaki slices, and the per-node
``_solve_node`` fallback (a fake Hamiltonian goes through the
``_batched_sigma`` hook instead).  One JAX fault is not copied: after a
"replace" step the trial set holds exactly the new Ritz vectors — the JAX
package keeps the stale slots past ``len(eigvals)``
(``feast_eom_ccsd.py:951-958``).
"""

import time
import warnings

import numpy as np
import torch
from scipy.linalg import eig
from torch.utils import _pytree

from pymes_tpu_torch.kernels import shifted
from pymes_tpu_torch.log import print_logging_info, print_title
from pymes_tpu_torch.ops import gmres as _gmres
from pymes_tpu_torch.parallel import mesh as _mesh
from pymes_tpu_torch.parallel import sharding as _sharding
from pymes_tpu_torch.solver.eom_ccsd import EOM_CCSD
from pymes_tpu_torch.util.precision import cast_f32, full_f32_matmul

LS_PRECISIONS = ("f64", "mixed")
# the f32 Krylov stalls near f32 rounding: its tolerance, at least this,
# only sets each refinement pass's contraction (feast_eom_ccsd.py:741-744)
TOL_F32 = 1e-5


def get_gauss_legendre_quadrature(n):
    return np.polynomial.legendre.leggauss(n)


def normalize_amps(u_singles, u_doubles):
    norm = np.tensordot(np.conj(u_singles), u_singles, axes=2)
    norm += np.tensordot(np.conj(u_doubles), u_doubles, axes=4)
    scale = np.sqrt(norm)
    return u_singles / scale, u_doubles / scale


class _NodeOps:
    """The shifted operators of one chunk of lanes (``_node_ops``,
    ``feast_eom_ccsd.py:46-108``): lane ℓ solves (z_ℓ − H̄)x = b_ℓ, or
    (z_ℓ − i·dt·H̄)x = b_ℓ with ``rt``; rows are (La, 2N) pairs."""

    def __init__(self, solver, op, zr, zi, rt, dt):
        self.solver, self.op = solver, op
        self.zr, self.zi, self.rt, self.dt = zr, zi, rt, dt

    def sigma(self, X):
        """H̄ on the Re and Im rows of each pair: one batched sigma over
        the 2La rows (Re_0, Im_0, Re_1, ...)."""
        return self.solver._sigma_parts(self.op,
                                        X.reshape(2 * X.shape[0], -1))

    def _k8(self, H1, H2, X, lanes, mode, B=None):
        return shifted.shifted_precond(
            H1, H2, X, self.zr[lanes], self.zi[lanes], self.op[3], self.dt,
            self.rt, mode, B=B, twin=self.solver.twin)

    def apply(self, X, lanes):
        """M(A x): the preconditioned operator GMRES calls."""
        H1, H2 = self.sigma(X)
        return self._k8(H1, H2, X, lanes, "apply")

    def precond(self, X, lanes):
        return self._k8(None, None, X.contiguous(), lanes, "precond")

    def residual(self, X, lanes, B):
        """(b − A x, ‖b − A x‖, ‖b‖) per lane: the vector r is the next
        right-hand side of the mixed engine's refinement."""
        H1, H2 = self.sigma(X)
        return self._k8(H1, H2, X.contiguous(), lanes, "residual",
                        B=B.contiguous())


class FEAST_EOM_CCSD(EOM_CCSD):
    """FEAST eigensolver in an energy window on ``device`` (reference API:
    ``feast_eom_ccsd.py:29``; the JAX package's ``FEAST_EOM_CCSD``).

    ``ls_precision``: "f64" (the default: every solve in f64) or "mixed"
    (f32 Krylov inside f64 iterative refinement, at most
    ``ls_refine_max`` = 4 passes a chunk; the module docstring); any other
    value raises.  ``ls_backend``: "inhouse" (lane-batched GMRES; "opt" is
    its alias, as in the JAX package) or "jacobi" (lane-batched
    Richardson).  ``ls_restart`` defaults to 120: GMRES(20) stalls on the
    near-axis nodes of tight UEG windows.  ``krylov_mem_budget_bytes``
    bounds the Krylov bases of one chunk of lanes, (ls_restart+1)·2N
    elements of the solve type a lane (8 bytes, 4 in the mixed engine);
    None means half the card's free memory at the start of a solve (2 GB
    on the CPU), per device of ``node_mesh``.  Chunking changes how lanes
    are batched, never a result.  ``node_mesh`` shards the quadrature
    nodes over its ``node_axis`` (module docstring).  ``twin=True`` runs
    every kernel through its plain twin."""

    def __init__(self, no, e_c=0.0, e_r=1.0, n_trial=5, max_iter=20,
                 tol=1e-12, n_quad=8, seed=None, n_excit=2, ls_conv_tol=1e-4,
                 node_mesh=None, *, device=None, ls_precision="f64"):
        super().__init__(no, n_excit=int(n_excit), device=device)
        self.algo_name = "FEAST-EOM-CCSD"
        self.e_c = e_c
        self.e_r = e_r
        self.n_trial = n_trial
        self.max_iter = max_iter
        self.tol = tol
        self.n_quad = n_quad
        self.ls_backend = "inhouse"
        self.ls_max_iter = 20
        self.ls_restart = 120
        self.ls_conv_tol = float(ls_conv_tol)
        self.ls_damping = 1.0
        self.ls_precision = ls_precision
        self.ls_refine_max = 4
        self.krylov_mem_budget_bytes = None
        self.node_mesh = node_mesh    # shard quadrature nodes over a mesh
        self.node_axis = "a"
        # relative singular-value floor of the filtered set (None: 10 ×
        # ls_conv_tol, floored at 1e-12; feast_eom_ccsd.py:468)
        self.svd_drop_tol = None
        self.trial_update = "replace"
        self.last_ls_residuals = None
        self.ls_stats = None
        self.u_singles = []
        self.u_doubles = []
        self.eigvals = np.array([e_c - e_r, e_c + e_r])
        self.eigvecs = None
        self._rng = np.random.default_rng(seed)

    @property
    def ls_precision(self):
        return self._ls_precision

    @ls_precision.setter
    def ls_precision(self, value):
        if value not in LS_PRECISIONS:
            raise ValueError(f"ls_precision {value!r}: one of "
                             f"{LS_PRECISIONS}")
        self._ls_precision = value

    # --- operator ---------------------------------------------------------
    def dump_log(self):
        """The reference class's log hook: a no-op, as in the JAX package
        (``ls_stats`` holds the solves' counts)."""

    def _operator(self, f, dict_t_V, T2):
        """(f, V, T2, diag) on the device, built once per (f, V, T2) triple
        with the H̄ intermediates and the f32 copy of both: the RT
        propagator calls solve() once per step with the same operator
        (``feast_eom_ccsd.py:479-490``)."""
        key = (id(f), id(dict_t_V), id(T2))
        if getattr(self, "_op_key", None) != key:
            self._hbar = None
            self._op32 = self._hbar32 = None
            fd = self._on_device(f)
            Vd = self._operator_on_device(dict_t_V)
            Td = self._on_device(T2).contiguous()
            self._op = (fd, Vd, Td, self._diag(fd, Vd, Td))
            self._op_key = key
        return self._op

    def _operator32(self, op):
        """The f32 copy of the operator ``op`` and of its H̄ intermediates
        (``_get_f32_operator``, ``feast_eom_ccsd.py:723-730``), built at the
        first mixed solve of an operator."""
        if self._op32 is None:
            self._hbar32 = cast_f32(self._hbar_of(*op[:3]))
            self._op32 = cast_f32(op)
        return self._op32

    def _hbar_of(self, f, dict_t_V, T2):
        """H̄'s intermediates: the f32 copy for the f32 operator, else the
        EOM solver's (built once per operator)."""
        if f.dtype == torch.float32:
            return self._hbar32
        return super()._hbar_of(f, dict_t_V, T2)

    def _krylov_budgets(self):
        """The Krylov budget of each device that solves lanes, taken at the
        start of a solve."""
        devices = (self.node_mesh.devices if self.node_mesh is not None
                   else (self.device,))
        out = {}
        for dev in devices:
            if self.krylov_mem_budget_bytes is not None:
                out[dev] = float(self.krylov_mem_budget_bytes)
            elif dev.type == "cuda":
                out[dev] = torch.cuda.mem_get_info(dev)[0] / 2
            else:
                out[dev] = 2e9
        return out

    def _warn_unconverged(self, rel_res):
        """Surface non-converged shifted solves instead of silently
        polluting the spectral projector (``feast_eom_ccsd.py:537``)."""
        rel_res = np.atleast_1d(np.asarray(rel_res))
        self.last_ls_residuals = rel_res
        bad = np.nonzero(rel_res > 10 * self.ls_conv_tol)[0]
        if len(bad):
            warnings.warn(
                "FEAST shifted solve(s) not converged: nodes "
                f"{bad.tolist()} rel. residuals "
                f"{rel_res[bad].tolist()} (ls_conv_tol={self.ls_conv_tol}, "
                f"ls_restart={self.ls_restart}, "
                f"ls_max_iter={self.ls_max_iter}) — near-real-axis nodes "
                "stagnate under short restarts: raise ls_restart, raise "
                "ls_max_iter, or loosen the window", stacklevel=3)

    def _new_stats(self):
        """``ls_stats``: lane chunks, operator applications (``calls``) and
        batched cycle ends of the Krylov solves, projected-H̄ sigmas, the
        Arnoldi steps of each lane of each Krylov solve, and in the mixed
        engine the refinement passes of each chunk and the matmul settings
        seen inside it."""
        self.ls_stats = {"chunks": 0, "calls": 0, "cycle_ends": 0,
                         "projections": 0, "steps": [], "passes": []}

    def _mixed(self):
        """The mixed engine runs for these backends and without a node mesh
        (``feast_eom_ccsd.py:609-614``)."""
        return (self.ls_precision == "mixed" and self.node_mesh is None
                and self.ls_backend in ("inhouse", "opt", "jacobi"))

    def _solve_lanes(self, op, B, zr, zi, rt=False, dt=0.0, per_node=1):
        """The shifted solves of all lanes: ``B`` (L, 2N) right-hand-side
        pairs, ``zr``/``zi`` (L,) shifts, node-major with ``per_node``
        lanes a node.  Returns X (L, 2N) on the solver's device and the
        honest relative residuals (numpy)."""
        if self.node_mesh is None:
            return self._solve_chunks(op, B, zr, zi, rt, dt,
                                      self._budget[self.device])
        mesh, axis = self.node_mesh, self.node_axis
        if axis not in mesh.shape:
            raise ValueError(f"node_axis {axis!r} is not an axis of the "
                             f"node mesh {mesh.axis_names}")
        L, n = B.shape
        nq = L // per_node
        lanes = _sharding.shard_over_nodes(
            (B.view(nq, per_node, n), zr.view(nq, per_node),
             zi.view(nq, per_node)), mesh, axis)
        sharded = lanes[0].axis == 0
        n_dev = mesh.shape[axis]
        print_logging_info(
            f"node mesh: {nq} nodes over {n_dev} devices, " + (
                f"{nq // n_dev} a device" if sharded else
                "not divisible: every device solves every node on its "
                "replica"), level=2)
        # each device's replica of the operator and of H̄ (on a repeated
        # device the tensors themselves); the sigma reads H̄ from _hbar
        hbar = self._hbar_of(*op[:3])
        reps = _sharding.replicate((op, hbar), mesh)
        X, rel = [], []
        try:
            for p, dev in enumerate(mesh.devices):
                op_p, self._hbar = _pytree.tree_map(
                    lambda s: s.shards[p] if isinstance(s, _mesh.Sharded)
                    else s, reps,
                    is_leaf=lambda s: isinstance(s, _mesh.Sharded))
                Bp, zr_p, zi_p = (t.shards[p] for t in lanes)
                x, r = self._solve_chunks(
                    op_p, Bp.reshape(-1, n), zr_p.reshape(-1),
                    zi_p.reshape(-1), rt, dt, self._budget[dev])
                X.append(x.to(self.device))
                rel.append(r)
        finally:
            self._hbar = hbar
        if sharded:
            return torch.cat(X), np.concatenate(rel)
        return X[0], rel[0]

    def _solve_chunks(self, op, B, zr, zi, rt, dt, budget):
        """The shifted solves of the lanes ``B`` on one device: lanes go in
        chunks whose Krylov bases fit ``budget`` bytes; per chunk, one
        lane-batched solve and the honest residual (one batched sigma + K8
        in residual mode, ``_residual_impl`` :360), or the mixed engine's
        refinement passes."""
        L, n = B.shape
        restart = int(self.ls_restart)
        if self.ls_backend not in ("inhouse", "opt", "jacobi"):
            raise ValueError(f"unknown ls_backend {self.ls_backend!r}")
        mixed = self._mixed()
        elem = 4 if mixed else 8
        per = max(1, int(budget // ((restart + 1) * n * elem)))
        per = -(-L // (-(-L // per)))     # even chunks
        X = torch.empty_like(B)
        rel = np.empty(L)
        for lo in range(0, L, per):
            sl = slice(lo, lo + per)
            node = _NodeOps(self, op, zr[sl], zi[sl], rt, dt)
            if mixed:
                X[sl], rel[sl] = self._refine(op, node, B[sl])
            else:
                X[sl] = self._krylov(node, B[sl], self.ls_conv_tol)
                lanes = torch.arange(X[sl].shape[0], device=B.device)
                _, res, bn = node.residual(X[sl], lanes, B[sl])
                rel[sl] = (res / torch.clamp(bn, min=1e-300)).cpu().numpy()
            self.ls_stats["chunks"] += 1
        return X, rel

    def _krylov(self, node, B, tol):
        """The lane-batched Krylov solve of one chunk's operator ``node`` on
        the right-hand sides ``B``, in B's type."""
        st = self.ls_stats
        restart = int(self.ls_restart)
        if self.ls_backend == "jacobi":
            # ls_max_iter counts restart-sized work units (:206-210)
            x, _, it = _gmres.richardson_lanes(
                lambda Xa, la: node.residual(Xa, la, B[la])[:2], B,
                node.precond, tol=tol, damping=self.ls_damping,
                max_iter=self.ls_max_iter * restart)
            st["steps"].append(it)
            return x
        x, _, info = _gmres.gmres_lanes(
            node.apply, B, node.precond, tol=tol, restart=restart,
            max_outer=self.ls_max_iter, twin=self.twin)
        st["steps"].append(info["steps"])
        st["calls"] += info["calls"]
        st["cycle_ends"] += info["cycle_ends"]
        return x

    def _refine(self, op, node, B):
        """The mixed engine on one chunk (``_solve_chunk_mixed``,
        ``feast_eom_ccsd.py:732-800``): from x = 0, each pass solves
        (z − H̄)dx = r in f32 to ``max(ls_conv_tol, TOL_F32)``, accumulates
        x += dx in f64 (``_accum_x`` :316) and takes the honest residual r
        with the f64 operator ``node``; it stops once every lane is at
        ``ls_conv_tol``, after ``ls_refine_max`` passes, or when the worst
        lane's residual is above half the last pass's (the stall test,
        :791-797: more passes repeat a stalled inner solve).  Returns x
        (f64) and the honest relative residuals (numpy)."""
        node32 = _NodeOps(self, self._operator32(op), node.zr.float(),
                          node.zi.float(), node.rt, node.dt)
        tol32 = max(self.ls_conv_tol, TOL_F32)
        lanes = torch.arange(B.shape[0], device=B.device)
        x = torch.zeros_like(B)
        cur = B
        rel_prev = np.inf
        passes = 0
        st = self.ls_stats
        with full_f32_matmul():
            st["matmul"] = (torch.get_float32_matmul_precision(),
                            torch.backends.cuda.matmul.allow_tf32,
                            torch.backends.cudnn.allow_tf32)
            for _ in range(max(1, int(self.ls_refine_max))):
                x += self._krylov(node32, cur.float(), tol32).double()
                passes += 1
                cur, res, bn = node.residual(x, lanes, B)
                rel = (res / torch.clamp(bn, min=1e-300)).cpu().numpy()
                if (np.all(rel <= self.ls_conv_tol)
                        or np.max(rel) > 0.5 * np.max(rel_prev)):
                    break
                rel_prev = rel
        st["passes"].append(passes)
        return x, rel

    def _sigma_parts(self, op, rows):
        """H̄ on the rows (k, N) on the device: one batched sigma through
        the ``_batched_sigma`` hook; returns its singles and doubles parts
        as (k, n1), (k, N − n1)."""
        f, V, T2, _ = op
        nv, no = T2.shape[0], T2.shape[-1]
        n1 = nv * no
        k = rows.shape[0]
        W1, W2 = self._batched_sigma(f, V, rows[:, :n1].reshape(k, nv, no),
                                     rows[:, n1:].reshape(k, nv, nv, no, no),
                                     T2)
        # in the rows' type and place (a hook may return f64 numpy)
        return tuple(torch.as_tensor(
            W if isinstance(W, torch.Tensor) else np.array(W),
            dtype=rows.dtype, device=rows.device).reshape(k, -1).contiguous()
            for W in (W1, W2))

    def _sigma_rows(self, op, Q):
        """H̄ on the rows of ``Q`` (k, N) numpy → (k, N) numpy: one batched
        sigma (``_apply_H`` of the JAX package, over all m_eff rows)."""
        self.ls_stats["projections"] += 1
        return torch.cat(self._sigma_parts(op, self._on_device(Q)),
                         dim=1).cpu().numpy()

    def _filter(self, op, Bset, z, node_weight):
        """Q_l = −Re Σ_e w_e (z_e − H̄)⁻¹ b_l for the m trials ``Bset``
        (m, N): one lane per (node, trial), node-major; the quadrature sum
        runs on the card and only Q comes down."""
        m, N = Bset.shape
        nq = len(z)
        dev = self.device
        B = torch.zeros((nq * m, 2 * N), dtype=torch.float64, device=dev)
        B[:, :N] = self._on_device(Bset).repeat(nq, 1)
        zr = torch.as_tensor(np.repeat(z.real, m), device=dev)
        zi = torch.as_tensor(np.repeat(z.imag, m), device=dev)
        X, rel = self._solve_lanes(op, B, zr, zi, per_node=m)
        self._warn_unconverged(rel.reshape(nq, m))
        X = X.view(nq, m, 2, N)
        Q = torch.zeros((m, N), dtype=torch.float64, device=dev)
        for e in range(nq):
            Q = Q + (float(node_weight[e].real) * X[e, :, 0]
                     - float(node_weight[e].imag) * X[e, :, 1])
        return (-Q).cpu().numpy()

    # --- FEAST iteration ----------------------------------------------------
    def solve(self, t_fock_dressed_pq, dict_t_V_dressed, t_T_abij):
        """FEAST iteration (``feast_eom_ccsd.py:818-972``); returns the
        eigenvalues of the last projected problem (numpy)."""
        print_title("FEAST-EOM-CCSD Solver")
        time_init = time.time()
        no = self.no
        op = self._operator(t_fock_dressed_pq, dict_t_V_dressed, t_T_abij)
        self._budget = self._krylov_budgets()
        self._new_stats()
        nv = op[2].shape[0]
        n1 = nv * no

        print_logging_info("Initialising u tensors...", level=1)
        # random trials drawn in the JAX order, so both packages start
        # from the same vectors; a second solve() starts clean
        self.u_singles = []
        self.u_doubles = []
        for _ in range(self.n_excit):
            self.u_singles.append(0.5 - self._rng.random((nv, no)))
            self.u_doubles.append(
                (0.5 - self._rng.random((nv, nv, no, no))) * 0.01)
        for l in range(len(self.u_singles)):
            self.u_singles[l], self.u_doubles[l] = normalize_amps(
                self.u_singles[l], self.u_doubles[l])

        x, w = get_gauss_legendre_quadrature(self.n_quad)
        theta = -np.pi / 2 * (x - 1)
        z = self.e_c + self.e_r * np.exp(1j * theta)
        node_weight = w / 2 * self.e_r * np.exp(1j * theta)

        e_norm_prev = 1e10
        self.iter_walls = []
        for it in range(self.max_iter):
            t_iter0 = time.time()
            m = len(self.u_singles)
            # orthonormalise the trial SET (feast_eom_ccsd.py:856-869)
            U_set = np.stack([np.concatenate([s.ravel(), d.ravel()])
                              for s, d in zip(self.u_singles,
                                              self.u_doubles)])
            q_set = np.linalg.qr(U_set.T)[0].T
            for l in range(m):
                self.u_singles[l] = q_set[l, :n1].reshape(nv, no)
                self.u_doubles[l] = q_set[l, n1:].reshape(nv, nv, no, no)
            Q = self._filter(op, q_set, z, node_weight)

            # rank-revealing orthonormalisation of the filtered set
            # (feast_eom_ccsd.py:888-896)
            drop = (self.svd_drop_tol if self.svd_drop_tol is not None
                    else max(10.0 * self.ls_conv_tol, 1e-12))
            _, sv, vt = np.linalg.svd(Q, full_matrices=False)
            m_eff = max(int(np.count_nonzero(sv > drop * sv[0])), 1)
            Q = [vt[i] for i in range(m_eff)]

            # projected oblique eigenproblem (B == I to machine precision
            # after the SVD; kept for parity with the reference)
            W = self._sigma_rows(op, np.stack(Q))
            H_proj = np.zeros((m_eff, m_eff))
            B = np.zeros((m_eff, m_eff))
            for i in range(m_eff):
                for j in range(m_eff):
                    H_proj[j, i] = Q[j] @ W[i]
                    B[j, i] = Q[j] @ Q[i]
            self.eigvals, self.eigvecs = eig(H_proj, B)
            # a singular B yields inf/nan pairs: drop those columns (each
            # eigenvector still has m_eff rows)
            finite = np.isfinite(self.eigvals)
            if not finite.all():
                self.eigvals = self.eigvals[finite]
                self.eigvecs = self.eigvecs[:, finite]
            if len(self.eigvals) == 0:
                print_logging_info(
                    "No finite eigenvalues in the energy window.", level=1)
                break

            ritz = [sum(np.real(self.eigvecs[i, l]) * Q[i]
                        for i in range(len(Q)))
                    for l in range(len(self.eigvals))]
            if m < self.n_trial:
                # extend the trial space with the filtered Ritz vectors
                for new in ritz:
                    self.u_singles.append(new[:n1].reshape(nv, no))
                    self.u_doubles.append(new[n1:].reshape(nv, nv, no, no))
            elif self.trial_update == "accumulate":
                # the reference's damped update (feast_eom_ccsd.py:936-950)
                for l, upd in enumerate(ritz):
                    self.u_singles[l] = self.u_singles[l] \
                        + upd[:n1].reshape(nv, no)
                    self.u_doubles[l] = self.u_doubles[l] \
                        + upd[n1:].reshape(nv, nv, no, no)
            else:
                # classical FEAST subspace iteration: the trial set
                # becomes exactly the Ritz rotation of the filtered set
                self.u_singles = [u[:n1].reshape(nv, no) for u in ritz]
                self.u_doubles = [u[n1:].reshape(nv, nv, no, no)
                                  for u in ritz]

            self.iter_walls.append(time.time() - t_iter0)
            e_norm = np.linalg.norm(self.eigvals)
            if np.abs(e_norm - e_norm_prev) < self.tol:
                break
            print_logging_info(
                f"Iter = {it}, Eigenvalues: {self.eigvals}", level=1)
            e_norm_prev = e_norm

        self.n_iterations = len(self.iter_walls)
        print_logging_info(
            f"FEAST-EOM-CCSD finished in {time.time() - time_init:.2f} "
            "seconds.", level=0)
        self.e_excit = self.eigvals
        return self.eigvals
