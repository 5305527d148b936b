"""Online serving of fitted pipelines: the plane and the fleet.

Counterpart of ``keystone_tpu/serving``. One process: the plane
(``plane.py``, its captured bucket graphs in ``graphs.py``), its model
records (``models.py``), the micro-batcher (``batcher.py``),
device-memory admission (``residency.py``) and the HTTP surface with
the ``serve`` command (``http.py``). The fleet: ``plan_placement``
packs models onto replicas under per-replica budgets
(``placement.py``), ``FleetRouter`` fronts N replicas with rendezvous
routing and honest spill (``router.py``), a replica is a plane that
takes its models over HTTP (``replica.py``), ``FleetController`` owns
the canonical model bytes and applies every placement change admit ->
sha-verify -> evict, and ``FleetAutoscaler`` turns measured telemetry
into membership changes (``fleet.py``). ``loadgen.py`` generates and
replays seeded traffic; ``scenarios`` is the chaos catalogue.
"""
from .batcher import (
    BucketPolicy,
    DeadlineExpiredError,
    MicroBatcher,
    QueueFullError,
    Request,
)
from .fleet import (
    FleetAutoscaler,
    FleetController,
    FleetError,
    FleetModel,
    run_reactor,
)
from .graphs import CaptureError
from .http import bind_server, predict_response, serve
from .models import ItemSpec, ServedModel
from .placement import ModelDemand, Placement, PlacementError, plan_placement
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
from .router import (
    FleetRouter,
    HttpReplicaClient,
    LocalReplicaClient,
    serve_router,
)

# the JAX package's public names; the port's own (CaptureError,
# ItemSpec, bind_server, fitted_model_nbytes, predict_response, serve)
# are imported above and stay importable from here
__all__ = [
    "AdmissionError",
    "BucketPolicy",
    "DeadlineExpiredError",
    "FleetAutoscaler",
    "FleetController",
    "FleetError",
    "FleetModel",
    "FleetRouter",
    "HttpReplicaClient",
    "LocalReplicaClient",
    "MicroBatcher",
    "ModelCharge",
    "ModelDemand",
    "ModelNotAdmitted",
    "ModelWarming",
    "Placement",
    "PlacementError",
    "PoisonedBatchError",
    "QueueFullError",
    "Request",
    "ResidencyLedger",
    "ServedModel",
    "ServingPlane",
    "model_charge",
    "plan_placement",
    "run_reactor",
    "serve_router",
]
