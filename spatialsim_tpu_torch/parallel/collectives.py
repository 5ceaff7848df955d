"""The collectives of the JAX package's sharded code, over a
:class:`~spatialsim_tpu_torch.parallel.mesh.BodyMesh`.

Every function is called by every rank of the group in the same order
(a rank that skips one leaves the others waiting), on tensors of the
rank's ``mesh.device``.  ``lax.ppermute`` becomes point-to-point sends:
:func:`shift` is the non-cyclic neighbour shift (a rank without a source
receives zeros, ``parallel/sharded.py:258-270`` in the JAX package),
:func:`ring_shift` the cyclic one (:80-92).  :func:`all_gather` is
``lax.all_gather(..., tiled=True)`` along an axis, :func:`all_to_all` the
untiled ``lax.all_to_all`` along dim 0, :func:`pmax` ``lax.pmax``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# all_gather_into_tensor is deprecated in favour of all_gather_single where
# the latter exists; both take (output, input, group).
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def shift(tensors, mesh, step):
    """Rank i's ``tensors`` arrive at rank ``i + step`` (``step`` +1 or -1);
    returns what this rank received, zeros where rank ``i - step`` does not
    exist.  One batch of point-to-point operations for all the tensors."""
    tensors = [t.contiguous() for t in tensors]
    out = [torch.zeros_like(t) for t in tensors]
    dst, src = mesh.rank + step, mesh.rank - step
    ops = []
    for t, o in zip(tensors, out):
        if 0 <= dst < mesh.size:
            ops.append(dist.P2POp(dist.isend, t, dst, mesh.group))
        if 0 <= src < mesh.size:
            ops.append(dist.P2POp(dist.irecv, o, src, mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def ring_shift(x, mesh):
    """Rank i's ``x`` arrives at rank ``(i + 1) % size``; one rank keeps its
    own."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (mesh.rank + 1) % mesh.size,
                      mesh.group),
           dist.P2POp(dist.irecv, out, (mesh.rank - 1) % mesh.size,
                      mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def all_gather(x, mesh, axis=0):
    """Every rank's ``x`` concatenated along ``axis`` in rank order (the
    tiled ``lax.all_gather``; a 0-d ``x`` gathers into ``(size,)``): the
    group gathers along dim 0 into ``(size, *x.shape)``, which moves to
    ``axis`` before the merge."""
    if x.dim() == 0:
        return all_gather(x.reshape(1), mesh)
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, group=mesh.group)
    out = out.reshape((mesh.size,) + tuple(x.shape))
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis] *= mesh.size
    return out.movedim(0, axis).reshape(shape)


def all_to_all(x, mesh):
    """Block j of ``x``'s dim 0 (``size`` equal blocks) goes to rank j;
    block i of the result came from rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out


def pmax(x, mesh):
    """The elementwise maximum of ``x`` over the group (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out
