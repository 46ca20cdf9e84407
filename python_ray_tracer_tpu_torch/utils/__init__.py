from .config import RenderConfig, require_cuda, resolve_backend, resolve_device
from .image import save_png, framebuffer_to_array
from .timing import time_fn, rays_per_image
from .checkpoint import save_pytree, load_pytree
