"""Online serving of fitted pipelines on one device.

Counterpart of the single-process half of ``keystone_tpu/serving``:
the plane (``plane.py``), its model records (``models.py``), the
micro-batcher (``batcher.py``), device-memory admission
(``residency.py``) and the HTTP surface with the ``serve`` command
(``http.py``). The fleet, router, placement, replica, load generator
and chaos scenarios are not ported yet (ROADMAP A10).
"""
from .batcher import (
    BucketPolicy,
    DeadlineExpiredError,
    MicroBatcher,
    QueueFullError,
    Request,
)
from .http import bind_server, predict_response, serve
from .models import ItemSpec, ServedModel
from .plane import (
    ModelNotAdmitted,
    ModelWarming,
    PoisonedBatchError,
    ServingPlane,
)
from .residency import (
    AdmissionError,
    ModelCharge,
    ResidencyLedger,
    fitted_model_nbytes,
    model_charge,
)

__all__ = [
    "AdmissionError",
    "BucketPolicy",
    "DeadlineExpiredError",
    "ItemSpec",
    "MicroBatcher",
    "ModelCharge",
    "ModelNotAdmitted",
    "ModelWarming",
    "PoisonedBatchError",
    "QueueFullError",
    "Request",
    "ResidencyLedger",
    "ServedModel",
    "ServingPlane",
    "bind_server",
    "fitted_model_nbytes",
    "model_charge",
    "predict_response",
    "serve",
]
