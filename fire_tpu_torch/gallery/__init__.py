"""Identity gallery: SQLite store, at-rest encryption and the
device-resident exact index."""

from fire_tpu_torch.gallery.crypto import Encryptor  # noqa: F401
from fire_tpu_torch.gallery.store import FaceStore  # noqa: F401
from fire_tpu_torch.gallery.index import DeviceGallery  # noqa: F401
