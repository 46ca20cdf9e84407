from .config import RenderConfig, resolve_backend
from .image import save_png, framebuffer_to_array
from .timing import time_fn, rays_per_image
from .checkpoint import save_pytree, load_pytree
