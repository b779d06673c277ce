"""MaxCut SDP construction from SuiteSparse ``.mat`` adjacency files.

Mirrors the reference's instance generator ``create_sedumi_maxcut``
(``lorads/data/gen_MaxCut.jl:213-243``): read ``Problem.A``, form the
weighted Laplacian L = D - A with D = diag(row sums), objective
C = -L/2 (the generator writes ``c = -0.5 * L[:]``; minimizing <C, X>
with diag(X) = e is the MaxCut SDP relaxation scaled by 2), constraints
diag(X) = 1.

For symmetric X, <C, X> = <sym(C), X>, so an unsymmetric adjacency (the
SuiteSparse p2p graphs are directed) is handled by symmetrizing C —
identical objective values to the reference pipeline.

The constraints are pure diagonal, so the canonical cone takes the
``diag`` fast path: A(RR^T) = row-norms^2 and A*(w) = diagonal scaling,
no gathers at all (cf. ``detectMaxCutProb``, ``lorads_solver.c:472-497``).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io
import scipy.sparse as sp

from ..problem import ConeData, SDPProblem, _sym_norms


def maxcut_problem_from_adjacency(A, name: str = "") -> SDPProblem:
    """Build the MaxCut SDP (min <-L/2, X>, diag(X)=e, X >= 0) from a
    (possibly unsymmetric) sparse adjacency matrix."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"adjacency must be square, got {A.shape}")

    row_sums = np.asarray(A.sum(axis=1)).ravel()
    D = sp.diags(row_sums)
    L = (D - A).tocoo()
    # C = sym(-L/2); for directed graphs sym via (M + M^T)/2
    C = (-0.25 * (L + L.T)).tocoo()
    C.sum_duplicates()
    mask = C.row <= C.col  # store upper triangle
    c_rows = C.row[mask].astype(np.int32)
    c_cols = C.col[mask].astype(np.int32)
    c_vals = C.data[mask].astype(np.float64)
    nz = c_vals != 0.0
    c_rows, c_cols, c_vals = c_rows[nz], c_cols[nz], c_vals[nz]

    idx = np.arange(n, dtype=np.int32)
    ones = np.ones(n)
    cone = ConeData(
        n=n, m=n,
        c_rows=c_rows, c_cols=c_cols, c_vals=c_vals,
        a_rows=idx, a_cols=idx, a_vals=ones, a_cid=idx,
        kind_a="diag", kind_c="sparse",
        n_active=n, active_cids=idx,
        diag_idx=idx, diag_val=ones, diag_cid=idx,
    )

    prob = SDPProblem(m=n, b=np.ones(n), cones=[cone], name=name)
    nrm1, nrm2sq, nrminf = _sym_norms(c_rows, c_cols, c_vals)
    prob.c_nrm1 = nrm1
    prob.c_nrm2 = float(np.sqrt(nrm2sq))
    prob.c_nrminf = nrminf
    prob.b_nrm1 = float(n)
    prob.b_nrm2 = float(np.sqrt(n))
    prob.b_nrminf = 1.0
    return prob


def load_maxcut_mat(path: str, name: str = "") -> SDPProblem:
    """Load a SuiteSparse ``Problem`` struct ``.mat`` file as a MaxCut SDP."""
    if not name:
        name = os.path.splitext(os.path.basename(path))[0]
    data = scipy.io.loadmat(path)
    if "Problem" in data:
        A = data["Problem"]["A"][0, 0]
    elif "A" in data:
        A = data["A"]
    else:
        raise ValueError(
            f"{path}: no 'Problem' struct or 'A' matrix in .mat file")
    return maxcut_problem_from_adjacency(A, name=name)
