from .scene import (Scene, Spheres, Planes, Lights, Materials, default_scene, random_scene,
                    Vector3D, Color)
from .camera import Camera, default_camera, euler_rotation
