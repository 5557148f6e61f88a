"""Several streams and the row-sharded gallery over a mesh of devices
(counterpart of ``fire_tpu.parallel``): one process drives every device,
as JAX's single-controller mesh does."""

from fire_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from fire_tpu_torch.parallel.sharded_gallery import sharded_cosine_topk  # noqa: F401
