"""Materialisation of encoding matrices from scheme descriptors.

For a matrix-vector scheme, the encoding matrix ``R`` is n x k_A with
row i supported on ``supports[i]``; worker i's coded submatrix is
``A_tilde_i = sum_q R[i, q] A_q``.

For a matrix-matrix scheme there are two such matrices ``R_A`` (n x k_A)
and ``R_B`` (n x k_B); the effective decoding row for worker i over the
k = k_A * k_B unknowns is the Khatri-Rao row ``kron(R_A[i], R_B[i])``.

Coefficient conventions per scheme:
  * proposed / cyclic31 / scs36 / class29 : i.i.d. Uniform(-1, 1) on the
    support (continuous distribution, as the paper requires for the
    Schwartz-Zippel argument).
  * rkrp   : i.i.d. standard normal, dense.
  * poly   : Vandermonde rows [1, z_i, z_i^2, ...] at distinct reals z_i.
  * orthopoly : Chebyshev basis T_j(z_i) at Chebyshev points (stable
    orthogonal-polynomial embedding of [32]).
  * repetition : single 1 on the supported block.

A numpy copy of ``repro.core.encoding``: coefficients come from
``np.random.default_rng(seed)`` exactly as there, so every matrix is
bitwise the reference's.
"""

from __future__ import annotations

import numpy as np

from .assignment import MMScheme, MVScheme


def _rng(seed: int | None) -> np.random.Generator:
    return np.random.default_rng(0 if seed is None else seed)


def support_mask(supports, k: int) -> np.ndarray:
    m = np.zeros((len(supports), k), dtype=bool)
    for i, t in enumerate(supports):
        m[i, list(t)] = True
    return m


def _poly_rows(n: int, k: int) -> np.ndarray:
    # distinct evaluation points in (-1, 1) to limit blow-up; still
    # ill-conditioned (Vandermonde), which is the point of Table III.
    z = np.linspace(-1.0, 1.0, n)
    return np.stack([z**j for j in range(k)], axis=1)


def _chebyshev_rows(n: int, k: int, stride: int = 1) -> np.ndarray:
    # Chebyshev points of the first kind; column j evaluates T_{j*stride}.
    # The stride implements the orthopoly analogue of the polynomial
    # code's degree jump for B (B(z) uses degrees j*k_A) so the
    # Khatri-Rao system over the k_A*k_B unknowns stays full rank [32].
    i = np.arange(n)
    z = np.cos((2 * i + 1) * np.pi / (2 * n))
    max_deg = (k - 1) * stride
    cheb = np.empty((n, max_deg + 1))
    cheb[:, 0] = 1.0
    if max_deg >= 1:
        cheb[:, 1] = z
    for j in range(2, max_deg + 1):
        cheb[:, j] = 2 * z * cheb[:, j - 1] - cheb[:, j - 2]
    return cheb[:, ::stride][:, :k].copy()


def _structured_random(supports, k: int, rng: np.random.Generator) -> np.ndarray:
    r = np.zeros((len(supports), k))
    for i, t in enumerate(supports):
        r[i, list(t)] = rng.uniform(-1.0, 1.0, size=len(t))
    return r


def mv_encoding_matrix(scheme: MVScheme, seed: int | None = None) -> np.ndarray:
    """R: (n_tasks x k) encoding matrix for a matrix-vector scheme."""
    k = scheme.k_A
    n_tasks = len(scheme.supports)
    rng = _rng(seed)
    if scheme.name == "poly":
        return _poly_rows(n_tasks, k)
    if scheme.name == "orthopoly":
        return _chebyshev_rows(n_tasks, k)
    if scheme.name == "rkrp":
        return rng.standard_normal((n_tasks, k))
    if scheme.name == "repetition":
        r = np.zeros((n_tasks, k))
        for i, t in enumerate(scheme.supports):
            r[i, t[0]] = 1.0
        return r
    return _structured_random(scheme.supports, k, rng)


def mm_encoding_matrices(scheme: MMScheme, seed: int | None = None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """(R_A, R_B): (n x k_A), (n x k_B) encoding matrices."""
    rng = _rng(seed)
    if scheme.name == "poly":
        # A(z) = sum_j A_j z^j ; B(z) = sum_j B_j z^{j * k_A}
        z = np.linspace(-1.0, 1.0, scheme.n)
        ra = np.stack([z**j for j in range(scheme.k_A)], axis=1)
        rb = np.stack([z ** (j * scheme.k_A) for j in range(scheme.k_B)], axis=1)
        return ra, rb
    if scheme.name == "orthopoly":
        ra = _chebyshev_rows(scheme.n, scheme.k_A)
        rb = _chebyshev_rows(scheme.n, scheme.k_B, stride=scheme.k_A)
        return ra, rb
    if scheme.name == "rkrp":
        return (rng.standard_normal((scheme.n, scheme.k_A)),
                rng.standard_normal((scheme.n, scheme.k_B)))
    ra = _structured_random(scheme.supports_A, scheme.k_A, rng)
    rb = _structured_random(scheme.supports_B, scheme.k_B, rng)
    return ra, rb


def khatri_rao_rows(ra: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """Row-wise Kronecker product: G[i] = kron(ra[i], rb[i]).

    G is the (n x k_A k_B) system matrix over the MM unknowns
    u_{q p} = A_q^T B_p with u flattened as q * k_B + p.
    """
    n = ra.shape[0]
    return (ra[:, :, None] * rb[:, None, :]).reshape(n, -1)


def encode_blocks(blocks: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Encode stacked block-columns: blocks (k, t, c) -> coded (n, t, c).

    Dense reference path (numpy).  The weight-omega gather encoder and
    its CUDA kernel live in ``repro_torch.kernels.cyclic_encode``.
    """
    k, t, c = blocks.shape
    return np.einsum("nk,ktc->ntc", R, blocks)


def encoded_nnz(blocks_nnz: np.ndarray, supports) -> np.ndarray:
    """Upper bound on non-zeros of each coded submatrix: sum of source
    nnz over the support (exact when supports' sparsity patterns are
    disjoint; tight for random sparsity, cf. Sec. IV-C's omega*mu model).
    """
    return np.array([sum(blocks_nnz[q] for q in t) for t in supports])
