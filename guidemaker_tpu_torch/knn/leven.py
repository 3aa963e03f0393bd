"""Exact Levenshtein k-NN and genome-scale Levenshtein retention.

The counterpart of the JAX package's ``knn/leven.py``.  Every function
takes tensors and runs on their device: the hand-written kernels on a CUDA
card (``stream.leven_topk``, ``stream.feature_count``, and the 2-bit
``stream.hamming_count``), their plain versions on the CPU.

Retention only asks whether each guide's second-nearest neighbor (the
first is itself) lies at distance >= e, and between equal-length guides
that has cheaper exact answers than a top-k (:func:`leven_pass_filter`):

* e == 2: one length-preserving edit is a substitution, so leven < 2 iff
  hamming < 2, and retention is the Hamming counting pass;
* e == 3: an edit script of cost <= 2 is either <= 2 substitutions
  (hamming <= 2: the counting pass) or one deletion and one insertion,
  which holds iff the two guides share a length-(L-1) deletion variant
  (:func:`delset_partner_mask`, one sort);
* e >= 4: the positional 3-gram filter (:mod:`.features`), sound but not
  exact, in tiers: the gram count; banded-DP verification of each
  ambiguous query's top candidates; the count in the other direction; the
  exact Myers k=2 top-k for what is left.

Given a ``mesh``, every tier runs over it (:mod:`.sharded`), as in the JAX
package: the counts and the Myers top-k on database shards, each shard's
3-gram rows built on its own device, the extraction merged by key, and the
banded verification split by row.  The deletion join stays on one device.
"""
from __future__ import annotations

import logging

import torch

from ..util import substage_timer
from . import sharded, stream
from .dp import banded_leven_pairs
from .features import GRAM_Q, feature_topk, gram_rows
from .hamming import IDX_MASK, pack_codes, unpack_keys

logger = logging.getLogger(__name__)

#: candidates a query of the e >= 4 filter's verification tier: queries
#: with at most this many filter hits are decided exactly by the banded
#: DP; more fall through to the second-direction count and the k=2 residue
_FILTER_K = 64
#: ambiguous queries verified at once: bounds the (queries x _FILTER_K)
#: candidate pairs held on the device
_VERIFY_CHUNK = 1 << 16


def leven_topk(q_codes: torch.Tensor, db_codes: torch.Tensor,
               k: int) -> torch.Tensor:
    """(nq, min(k, nd)) int32 packed keys ``(dist << 24) | idx`` of the k
    nearest database guides by Levenshtein distance, ascending, for (nq, L)
    and (nd, L) uint8 codes on one device; ``k`` <= 128."""
    return stream.leven_topk(pack_codes(q_codes), pack_codes(db_codes),
                             q_codes.shape[1], k)


def delset_partner_mask(codes: torch.Tensor) -> torch.Tensor:
    """(n,) bool: does guide i share a deletion variant (itself with one
    base deleted) with another guide?  For equal-length guides that is the
    one-deletion-one-insertion case of leven <= 2.

    Each of the n*L variants packs at 2 bits a base into an int64; one
    ``torch.sort`` groups equal variants, and every run of equal variants
    with two owners or more marks its owners.  A variant that holds an N
    matches nothing and takes no part."""
    n, length = codes.shape
    dev = codes.device
    c = codes.to(torch.int64)
    is_n = c >= 4
    w = torch.ones(length, dtype=torch.int64, device=dev) << (
        2 * torch.arange(length, device=dev))
    pref = torch.zeros((n, length + 1), dtype=torch.int64, device=dev)
    pref[:, 1:] = torch.cumsum(torch.where(is_n, 0, c) * w, dim=1)
    # variant d: the bases before d at their weights, plus the bases after
    # d one position down; the sum wraps past 2**63 at 32 bases, so the
    # shift clears the two bits an arithmetic shift would fill
    after = ((pref[:, length:] - pref[:, 1:]) >> 2) & ((1 << 62) - 1)
    variants = pref[:, :length] + after
    clean = (is_n.sum(1, keepdim=True) - is_n.to(torch.int64)) == 0
    owners = torch.arange(n, device=dev)[:, None].expand(n, length)
    v, own = variants[clean], owners[clean]
    partner = torch.zeros(n, dtype=torch.bool, device=dev)
    if v.numel() < 2:
        return partner
    ob = max((n - 1).bit_length(), 1)
    if 2 * (length - 1) + ob <= 63:
        # composite (variant, owner) key: one flat int64 sort
        keys = torch.sort((v << ob) | own).values
        v_s, own_s = keys >> ob, keys & ((1 << ob) - 1)
    else:
        v_s, order = torch.sort(v, stable=True)
        own_s = own[order]
    # owners ascend inside a run, so every block of one owner in a run
    # with two owners or more borders another owner
    flag = (v_s[1:] == v_s[:-1]) & (own_s[1:] != own_s[:-1])
    partner[own_s[:-1][flag]] = True
    partner[own_s[1:][flag]] = True
    return partner


def match_rows(q_codes: torch.Tensor, db_codes: torch.Tensor) -> torch.Tensor:
    """(nq,) int64 row of each query in the deduplicated database (rows
    absent from it map to row 0; callers hold the precondition that every
    query is a member)."""
    nd = db_codes.shape[0]
    _, inv = torch.unique(torch.cat([db_codes, q_codes]), dim=0,
                          return_inverse=True)
    table = torch.zeros(int(inv.max()) + 1, dtype=torch.int64,
                        device=db_codes.device)
    table[inv[:nd]] = torch.arange(nd, device=db_codes.device)
    return table[inv[nd:]]


def _close_neighbors(q_codes: torch.Tensor, q_feat: torch.Tensor,
                     db_codes: torch.Tensor, db_feat, k_eff: int, t: int,
                     mesh=None) -> torch.Tensor:
    """(m,) bool: does each query have a neighbor other than itself at
    Levenshtein distance <= ``t`` among its ``k_eff`` candidates of
    smallest filter pseudo-distance?  Exhaustive, hence exact, for a query
    whose filter count is at most ``k_eff``.  With a ``mesh``, ``db_feat``
    is sharded over it, and so is the work."""
    glen = q_feat.shape[1]
    out = []
    for lo in range(0, q_codes.shape[0], _VERIFY_CHUNK):
        qc = q_codes[lo:lo + _VERIFY_CHUNK]
        qf = q_feat[lo:lo + _VERIFY_CHUNK]
        with substage_timer(f"leven tier: extraction m={qc.shape[0]} "
                            f"k={k_eff}", q_codes.device):
            if mesh is None:
                cand = feature_topk(qf, db_feat, glen, k_eff) & IDX_MASK
            else:
                cand = sharded.sharded_feature_topk(
                    qf, db_feat, glen, k_eff, mesh=mesh).to(
                        qc.device) & IDX_MASK
        with substage_timer(f"leven tier: banded pairs "
                            f"n={cand.numel()}", q_codes.device):
            qa = qc.repeat_interleave(k_eff, dim=0)
            ca = db_codes[cand.reshape(-1).long()]
            if mesh is None:
                dist = banded_leven_pairs(qa, ca, t)
            else:
                dist = sharded.sharded_banded_pairs(qa, ca, t=t,
                                                    mesh=mesh).to(qc.device)
            dist = dist.reshape(cand.shape)
            # distance 0 is the query itself (deduplicated database)
            out.append(((dist > 0) & (dist <= t)).any(dim=1))
    return torch.cat(out)


def _second_dist(q_codes: torch.Tensor, db_codes: torch.Tensor,
                 mesh) -> torch.Tensor:
    """(nq,) int32 Levenshtein distance of each query's second-nearest
    database guide, by the exact k=2 top-k, on the queries' device."""
    if mesh is None:
        return unpack_keys(leven_topk(q_codes, db_codes, 2))[0][:, 1]
    dist, _ = sharded.sharded_leven_topk(q_codes, db_codes, 2, mesh=mesh)
    return torch.from_numpy(dist[:, 1]).to(q_codes.device)


def leven_pass_filter(q_codes: torch.Tensor, db_codes: torch.Tensor,
                      editdist: int, *, filter_k: int = _FILTER_K,
                      mesh=None) -> torch.Tensor:
    """(nq,) bool, on the codes' device: is each query's second-nearest
    Levenshtein neighbor at distance >= ``editdist``?  Requires the
    counting preconditions (a deduplicated database of which every query is
    a member); pass the same tensor for an all-vs-all run.  With a
    :class:`.sharded.Mesh`, every tier but the deletion join runs over
    it."""
    nq, length = q_codes.shape
    dev = q_codes.device
    e = int(editdist)
    if e <= 1:
        # only the query itself is at distance 0 (dedup and membership),
        # so everything passes; e == 0 is vacuous, as in the reference
        return torch.ones(nq, dtype=torch.bool, device=dev)
    same = q_codes is db_codes
    if e in (2, 3):
        if mesh is None:
            db_rows = pack_codes(db_codes)
            q_rows = db_rows if same else pack_codes(q_codes)
            counts = stream.hamming_count(q_rows, db_rows, length, e)
        else:
            counts = sharded.fused_sharded_count(
                q_codes, sharded.prepare_db_sharded(db_codes, mesh),
                e).to(dev)
        if e == 2:
            return counts <= 1
        with substage_timer("leven e=3: deletion join", dev):
            partner = delset_partner_mask(db_codes)
            if not same:
                partner = partner[match_rows(q_codes, db_codes)]
        return (counts <= 1) & ~partner
    t = e - 1
    glen = length - GRAM_Q + 1
    p_edit = t * GRAM_Q + 1
    if glen - t * GRAM_Q < 2 or p_edit > glen:
        # the gram bound is void on guides this short: exact k=2 for all
        return _second_dist(q_codes, db_codes, mesh) >= e
    # a candidate pair has pseudo-distance glen - dot < p_edit
    thresh = glen - p_edit
    k_eff = min(filter_k, db_codes.shape[0])
    if mesh is not None:
        # each shard builds its 3-gram rows from its codes, on its device
        db_sh = sharded.shard_rows(db_codes, mesh)
    with substage_timer(f"leven tier 1: gram rows and count n={nq}", dev):
        q_feat = gram_rows(q_codes, 0)
        if mesh is None:
            db_feat = gram_rows(db_codes, t)
            counts = stream.feature_count(q_feat, db_feat, glen, thresh)
        else:
            db_feat = db_sh.map(lambda c: gram_rows(c, t))
            counts = sharded.sharded_feature_count(
                q_feat, db_feat, glen, thresh, mesh=mesh).to(dev)
        passed = counts <= 1
        todo = torch.nonzero(counts >= 2).squeeze(1)
    logger.debug("leven filter: %d queries, %d ambiguous after the gram "
                 "count", nq, todo.numel())
    if todo.numel() == 0:
        return passed
    # tier 2: banded verification of the candidates.  A list is exhaustive
    # when the count fits it; a proven close neighbor decides FAIL even
    # when it does not
    close = _close_neighbors(q_codes[todo], q_feat[todo], db_codes, db_feat,
                             k_eff, t, mesh)
    complete = counts[todo] <= k_eff
    passed[todo] = complete & ~close
    rest = todo[~complete & ~close]
    logger.debug("leven filter: %d overflowed the candidate lists",
                 rest.numel())
    if rest.numel() == 0:
        return passed
    # tier 3: the count in the other direction (the lemma is symmetric),
    # query rows dilated and database rows plain: a true close pair is
    # counted both ways, so a count <= 1 proves PASS
    with substage_timer(f"leven tier 3: count n={rest.numel()}", dev):
        q_dil = gram_rows(q_codes[rest], t)
        if mesh is None:
            db_plain = gram_rows(db_codes, 0)
            counts2 = stream.feature_count(q_dil, db_plain, glen, thresh)
        else:
            db_plain = db_sh.map(lambda c: gram_rows(c, 0))
            counts2 = sharded.sharded_feature_count(
                q_dil, db_plain, glen, thresh, mesh=mesh).to(dev)
        passed[rest[counts2 <= 1]] = True
        sel = torch.nonzero(counts2 >= 2).squeeze(1)
    if sel.numel() == 0:
        return passed
    rest2 = rest[sel]
    close = _close_neighbors(q_codes[rest2], q_dil[sel], db_codes, db_plain,
                             k_eff, t, mesh)
    complete = counts2[sel] <= k_eff
    passed[rest2] = complete & ~close
    over = rest2[~complete & ~close]
    logger.debug("leven filter: %d queries left for the exact k=2 top-k",
                 over.numel())
    if over.numel():
        # tier 4: exact k=2 for the residue, ambiguous both ways
        with substage_timer(f"leven tier 4: k=2 top-k n={over.numel()}",
                            dev):
            passed[over] = _second_dist(q_codes[over], db_codes, mesh) >= e
    return passed
