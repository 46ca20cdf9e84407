"""Ray-parallel sharding over ``torch.distributed``: each rank renders, or
takes the training step of, a vertical slice of the frame, and a step's only
collective is one all-reduce of the gradients with the loss beside them
(counterpart of ``python_ray_tracer_tpu/parallel``)."""
from .distributed import gather_framebuffer, initialize
from .mesh import RAY_AXIS, Mesh, column_slice, make_mesh
from .render_sharded import make_loss_fn, render_image_sharded

__all__ = ["RAY_AXIS", "Mesh", "column_slice", "make_mesh", "initialize",
           "gather_framebuffer", "render_image_sharded", "make_loss_fn"]
