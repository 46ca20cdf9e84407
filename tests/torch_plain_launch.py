"""Stand-ins for the kernel launches on a host without a card.

The port's kernel wrappers take CUDA tensors only, and its ``backend="cuda"``
entry points need a card. A CPU test of the glue around a launch (slices,
``unflatten_grads``, the sharded step's all-reduce over gloo, the fused and
unfused steps, the camera chain) applies :func:`plain_launches`: the checks
that refuse CPU tensors let them through, and each launch site computes its
plain version instead, so the glue runs as it does on a card around plain
numbers. A CPU test of ``render_cuda.large_scene_tables``' glue applies
:func:`plain_tables` (which :func:`plain_launches` includes): its three table
launches compute their plain versions. Both patch module attributes with the
``setattr`` they are given (``monkeypatch.setattr`` in a test; the builtin in
a spawned process that exits after), and change nothing in the package.
"""
from python_ray_tracer_tpu_torch import animation, train
from python_ray_tracer_tpu_torch.ops.cuda import cull_tables as ct
from python_ray_tracer_tpu_torch.ops.cuda import hit_extents_cuda as hx
from python_ray_tracer_tpu_torch.ops.cuda import light_cells_cuda as lc
from python_ray_tracer_tpu_torch.ops.cuda import render_bwd_cuda as rb
from python_ray_tracer_tpu_torch.ops.cuda import render_cuda, shadow_lists_cuda as sl
from python_ray_tracer_tpu_torch.ops.cuda import soft_bwd_cuda as sb, soft_cuda
from python_ray_tracer_tpu_torch.ops.render import render_image
from python_ray_tracer_tpu_torch.parallel import render_sharded
from python_ray_tracer_tpu_torch.utils.config import BACKENDS


def _backend(backend):
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    return backend


def _any_device(what, *tensors):
    return tensors[0].device


def _render_packed(camera, scene, packed, *, depth, mode, compat, x_offset=0,
                   local_width=None, **_):
    return render_image(camera, scene, depth=depth, aliasing=mode != "aa_none",
                        compat=compat, x_offset=x_offset, local_width=local_width)


def _bwd_run(camera, scene, image, target, *, depth, compat, mode, x_offset=0, lw=None,
             **_):
    kw = dict(depth=depth, compat=compat, x_offset=x_offset, local_width=lw)
    if mode.startswith("fused"):
        return rb.loss_and_scene_grads_plain(camera, scene, target,
                                             aliasing=mode == "fused_aa", **kw)
    return rb.scene_grads_plain(camera, scene, image, aliasing=mode != "cot_noaa", **kw)


def _soft_run(camera, scene, image, *, tau, mode, shape, x_offset=0, lw=None):
    kw = dict(tau=tau, x_offset=x_offset, local_width=lw)
    if mode == "fused":
        return sb.soft_loss_and_grads_plain(camera, scene, image, **kw)
    return sb.soft_scene_grads_plain(camera, scene, image, **kw)


def _soft_render(camera, scene, *, tau=0.05):
    soft_cuda.check_inputs(camera, scene, tau)
    return soft_cuda.render_image_soft_plain(camera, scene, tau=tau)


def _hit_extents(camera, scene, *, aliasing, compat=True, n_levels=1, vis=None, tree=None,
                 scale=None, x_offset=0, local_width=None):
    ext = hx.hit_extents_plain(camera, scene, aliasing=aliasing, compat=compat,
                               n_levels=n_levels, vis=vis, x_offset=x_offset,
                               local_width=render_cuda.slice_width(camera, x_offset,
                                                                   local_width))
    if scale is not None:
        scale.copy_(ct.extent_scale(ext).reshape(1))
    return ext


def _light_cells(sph, lts, ns, nl):
    return lc.light_cells_plain(sph[0:3, :ns].T, sph[3, :ns], lts[:, :nl].T)


def _shadow_lists(ext, scale, lights, centers, radii, *, K, compat):
    return ct.shadow_visibility_lists(ext, lights, centers, radii, K=K, compat=compat,
                                      scale=scale)


def plain_tables(setattr) -> None:
    """The large-scene table wrappers (``hit_extents_cuda``, with the scale
    it writes, ``light_cells_cuda`` and ``shadow_lists_cuda``) replaced by
    their plain versions, so ``render_cuda.large_scene_tables`` builds the
    same tables from CPU tensors."""
    setattr(hx, "hit_extents_cuda", _hit_extents)
    setattr(lc, "light_cells_cuda", _light_cells)
    setattr(sl, "shadow_lists_cuda", _shadow_lists)


def plain_launches(setattr) -> None:
    """Let the ``"cuda"`` backend and the hard and soft wrappers take CPU
    tensors, each launch replaced by its plain version: the hard render
    (``render_cuda.render_packed``), the hard backward (``render_bwd_cuda._run``),
    the soft backward (``soft_bwd_cuda._run``) and, in ``train``, the soft
    forward wrapper (its launch sits inside a CUDA device context); and
    :func:`plain_tables`."""
    plain_tables(setattr)
    for mod in (train, render_sharded, animation):
        setattr(mod, "resolve_backend", _backend)
    for mod in (train, render_sharded, animation, render_cuda, rb, soft_cuda, sb):
        setattr(mod, "require_cuda", _any_device)
    setattr(render_cuda, "render_packed", _render_packed)
    setattr(rb, "_run", _bwd_run)
    setattr(sb, "_run", _soft_run)
    setattr(train, "render_image_soft_cuda", _soft_render)
