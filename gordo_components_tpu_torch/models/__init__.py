"""Model zoo of the port: torch modules behind the reference's estimator
API, loaded from the reference's artifacts or trained by the port."""

from .register import get_factory, register_model_factory  # noqa: F401
from .models import (  # noqa: F401
    BaseTorchEstimator,
    DenseAutoEncoder,
    KerasAutoEncoder,
    KerasLSTMAutoEncoder,
    KerasLSTMForecast,
    LSTMAutoEncoder,
    LSTMForecast,
    MultiStepForecast,
    PatchTSTAutoEncoder,
    PatchTSTForecast,
)
