"""Physical atom-permutation (symmetry) recovery.

Rebuild of the reference symmetry finder (reference:
sgdml/utils/perm.py:48-359): pairwise bipartite matching (Hungarian) on
adjacency-spectrum features with a same-species penalty, permutation
synchronization over a minimum spanning tree of match costs, transitive group
closure capped at 100 permutations, and a salvage fallback.

Host-side NumPy/SciPy by design: this is combinatorial preprocessing that
runs once per task; its *output ordering* must be deterministic because the
descriptor permutations change kernel entries one-for-one (SURVEY.md §7.4).
The reference's fork-pool parallelism is replaced by a vectorized O(M^2)
loop — eigendecompositions are batched, matching is the only serial part.

A verbatim copy of ``mlff_tpu.models.symmetry`` (host NumPy only), so that the port
imports nothing of the JAX package; equal seeds give bitwise-equal arrays.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import scipy.spatial.distance
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import minimum_spanning_tree

from ..utils.log import get_logger

log = get_logger(__name__)


def _adjacency_features(R: np.ndarray):
    """Per-geometry adjacency (condensed pdist) and eigenvector features,
    sorted by descending eigenvalue (reference perm.py:154-195)."""
    M, n_atoms, _ = R.shape
    adj_set = np.empty((M, n_atoms * (n_atoms - 1) // 2))
    v_set = np.empty((M, n_atoms, n_atoms))
    for i in range(M):
        adj = scipy.spatial.distance.pdist(R[i], "euclidean")
        w, v = np.linalg.eig(scipy.spatial.distance.squareform(adj))
        v = v[:, w.argsort()[::-1]]
        adj_set[i] = adj
        v_set[i] = np.real(v)
    return adj_set, v_set


def bipartite_match(R: np.ndarray, z: np.ndarray):
    """All-pairs Hungarian matching of atoms between geometries
    (reference perm.py:53-233).  Returns (match_perms dict, match_cost csr)."""
    M, n_atoms, _ = R.shape

    same_z_cost = np.repeat(z[:, None], len(z), axis=1) - z
    same_z_cost[same_z_cost != 0] = 1

    adj_set, v_set = _adjacency_features(R)
    match_cost = np.zeros((M, M))
    match_perms = {}

    for i in range(M):
        adj_i = scipy.spatial.distance.squareform(adj_set[i])
        v_i = np.abs(v_set[i])
        for j in range(i + 1, M):
            adj_j = scipy.spatial.distance.squareform(adj_set[j])
            cost = -v_i @ np.abs(v_set[j]).T
            cost += same_z_cost * np.max(np.abs(cost))
            _, perm = scipy.optimize.linear_sum_assignment(cost)

            adj_i_perm = adj_i[perm][:, perm]
            score_before = np.linalg.norm(adj_i - adj_j)
            score = np.linalg.norm(adj_i_perm - adj_j)

            match_cost[i, j] = score if score < score_before else score_before
            if score < score_before and not np.isclose(score_before, score):
                match_perms[i, j] = perm

    match_cost = match_cost + match_cost.T
    match_cost[np.diag_indices_from(match_cost)] = np.inf
    return match_perms, csr_matrix(match_cost)


def sync_perm_mat(match_perms_all: dict, match_cost, n_atoms: int) -> np.ndarray:
    """Keep only the matchings on a minimum spanning tree of the match costs
    (permutation synchronization, reference perm.py:236-257)."""
    tree = minimum_spanning_tree(match_cost, overwrite=True)
    perms = np.arange(n_atoms, dtype=int)[None, :]
    rows, cols = tree.nonzero()
    for edge in zip(rows, cols):
        perm = match_perms_all.get(edge)
        if perm is not None:
            perms = np.vstack((perms, perm))
    return np.unique(perms, axis=0)


def _to_cycles(perm):
    pi = {i: perm[i] for i in range(len(perm))}
    cycles = []
    while pi:
        elem0 = next(iter(pi))
        this_elem = pi[elem0]
        next_item = pi[this_elem]
        cycle = []
        while True:
            cycle.append(this_elem)
            del pi[this_elem]
            this_elem = next_item
            if next_item in pi:
                next_item = pi[next_item]
            else:
                break
        cycles.append(cycle)
    return cycles


def salvage_subgroup(perms: np.ndarray) -> np.ndarray:
    """If closure diverges, keep the permutation of largest cycle-LCM
    (reference perm.py:285-296)."""
    n_perms, n_atoms = perms.shape
    lcms = [
        np.lcm.reduce([len(cy) for cy in _to_cycles(list(perms[i]))])
        for i in range(n_perms)
    ]
    keep = int(np.argmax(lcms))
    return np.vstack((np.arange(n_atoms), perms[keep]))


def complete_sym_group(perms: np.ndarray, n_perms_max: int | None = 100):
    """Transitive closure of the permutation set (reference perm.py:299-334).
    Returns None if the closure exceeds ``n_perms_max`` elements."""
    perm_added = True
    while perm_added:
        perm_added = False
        n_perms = perms.shape[0]
        for i in range(n_perms):
            for j in range(n_perms):
                new_perm = perms[i, perms[j]]
                if not (new_perm == perms).all(axis=1).any():
                    perm_added = True
                    perms = np.vstack((perms, new_perm))
                    if n_perms_max is not None and perms.shape[0] == n_perms_max:
                        return None
    return perms


def find_perms(R: np.ndarray, z: np.ndarray, max_geometries: int = 100) -> np.ndarray:
    """Recover the physical permutation group from sample geometries
    (reference perm.py:337-358).  ``R`` (M, A, 3), ``z`` (A,)."""
    M, n_atoms = R.shape[:2]
    if M > max_geometries:
        # deterministic subset for speed; reference subsamples 1000 randomly
        # at task level (train.py:476-479)
        R = R[np.linspace(0, M - 1, max_geometries).astype(int)]
        M = max_geometries

    match_perms_all, match_cost = bipartite_match(R, z)
    match_perms = sync_perm_mat(match_perms_all, match_cost, n_atoms)

    sym_group_perms = complete_sym_group(match_perms, n_perms_max=100)
    if sym_group_perms is None:
        log.warning("transitive closure failed; salvaging largest subgroup")
        match_perms_subset = salvage_subgroup(match_perms)
        sym_group_perms = complete_sym_group(match_perms_subset, n_perms_max=100)
    log.info("found %d symmetries", sym_group_perms.shape[0])
    return sym_group_perms


def inv_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


# Cordero et al. 2008 single-bond covalent radii (Angstrom), common elements
_COVALENT_RADII = {
    1: 0.31, 2: 0.28, 3: 1.28, 4: 0.96, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66,
    9: 0.57, 10: 0.58, 11: 1.66, 12: 1.41, 13: 1.21, 14: 1.11, 15: 1.07,
    16: 1.05, 17: 1.02, 18: 1.06, 19: 2.03, 20: 1.76, 26: 1.32, 29: 1.32,
    30: 1.22, 35: 1.20, 53: 1.39,
}


def covalent_adjacency(r0: np.ndarray, z: np.ndarray, scale: float = 1.25):
    """Bond-adjacency matrix from covalent-radii distance cutoffs.

    Replaces the reference's ASE ``Analysis(atoms).adjacency_matrix``
    (perm.py:373-377) with the same standard criterion ASE uses:
    bonded iff dist(i, j) < scale * (r_cov_i + r_cov_j).  Assumes Angstrom,
    like the reference ("assumes Ang!", perm.py:367)."""
    rc = np.array([_COVALENT_RADII.get(int(zi), 1.5) for zi in z])
    dist = scipy.spatial.distance.squareform(
        scipy.spatial.distance.pdist(r0, "euclidean")
    )
    cutoff = scale * (rc[:, None] + rc[None, :])
    adj = (dist < cutoff) & ~np.eye(len(z), dtype=bool)
    return adj


def find_frag_perms(
    R: np.ndarray, z: np.ndarray, max_frames: int = 10
) -> np.ndarray:
    """Permutations of identical non-bonded molecular fragments
    (reference perm.py:361-527, gated behind USE_FRAG_PERMS=False at
    train.py:500).

    Pipeline (the functional core of the reference; its trailing
    hardcoded-index alignment experiment is molecule-specific debug code and
    intentionally not reproduced):

      1. connected components of the bond graph of frame 0 -> fragments,
      2. for every fragment pair with equal sorted composition, match the
         two fragments with :func:`find_perms` over up to ``max_frames``
         frames and embed each local permutation as a global fragment swap,
      3. deduplicate and transitively close the resulting set.

    Returns the identity set when the molecule is a single connected
    fragment (or fragmentation looks pathological — every atom isolated).
    """
    from scipy.sparse.csgraph import connected_components

    M, n_atoms = R.shape[:2]
    adj = covalent_adjacency(R[0], z)
    n_frags, labels = connected_components(
        csgraph=csr_matrix(adj), directed=False, return_labels=True
    )
    frags = [np.where(labels == lbl)[0] for lbl in range(n_frags)]

    if n_frags == 1:
        log.info("single connected fragment; no fragment permutations")
        return np.arange(n_atoms)[None, :]
    if n_frags == n_atoms:
        log.warning(
            "every atom is its own fragment (length unit not Angstrom?); "
            "skipping fragment symmetry search"
        )
        return np.arange(n_atoms)[None, :]
    log.info("found %d disconnected fragments", n_frags)

    swap_perms = [np.arange(n_atoms)]
    for f1 in range(n_frags):
        for f2 in range(f1 + 1, n_frags):
            sort_f1 = np.argsort(z[frags[f1]], kind="stable")
            sort_f2 = np.argsort(z[frags[f2]], kind="stable")
            z1 = z[frags[f1]][sort_f1]
            z2 = z[frags[f2]][sort_f2]
            if not np.array_equal(z1, z2):
                continue
            inv_sort_f2 = inv_perm(sort_f2)
            for ri in range(min(max_frames, M)):
                R_pair = np.stack([
                    R[ri, frags[f1]][sort_f1],
                    R[ri, frags[f2]][sort_f2],
                ])
                for p in find_perms(R_pair, z1):
                    match_perm = sort_f1[p][inv_sort_f2]
                    swap = np.arange(n_atoms)
                    swap[frags[f1]] = frags[f2][match_perm]
                    swap[frags[f2][match_perm]] = frags[f1]
                    swap_perms.append(swap)

    swap_perms = np.unique(np.asarray(swap_perms), axis=0)
    sym_group_perms = complete_sym_group(swap_perms, n_perms_max=100)
    if sym_group_perms is None:
        log.warning("fragment-perm closure exceeded 100; salvaging subgroup")
        sym_group_perms = complete_sym_group(
            salvage_subgroup(swap_perms), n_perms_max=100
        )
    log.info("found %d fragment permutations after closure",
             sym_group_perms.shape[0])
    return sym_group_perms
