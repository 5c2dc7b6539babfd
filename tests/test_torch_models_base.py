"""The port's estimator contract (``models/base.py``, ``models/anomaly/base.py``)
against the reference's.

``GordoBase`` and ``AnomalyDetectorBase`` declare the same abstract methods
as the reference's; their defaults (``set_params``, ``get_state``,
``set_state``) behave alike; ``clone_estimator`` makes an unfitted copy whose
``get_params`` equals the original's, for every estimator, scaler, pipeline
class and detector of the port; and ``isinstance`` of each class's instance
against both bases answers as the reference's class of the same name does.
An artifact the reference writes still loads in the port, whose objects are
then instances of the contract.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gordo_components_tpu.models as ref_models  # noqa: E402
import gordo_components_tpu.models.anomaly as ref_anomaly  # noqa: E402
import gordo_components_tpu.models.pipeline as ref_pipeline  # noqa: E402
import gordo_components_tpu.models.transformers as ref_transformers  # noqa: E402
from gordo_components_tpu.models.base import clone_estimator as ref_clone  # noqa: E402

import gordo_components_tpu_torch.models as models  # noqa: E402
import gordo_components_tpu_torch.models.anomaly as anomaly  # noqa: E402
import gordo_components_tpu_torch.models.pipeline as pipeline  # noqa: E402
import gordo_components_tpu_torch.models.transformers as transformers  # noqa: E402
from gordo_components_tpu_torch.models.anomaly.base import AnomalyDetectorBase  # noqa: E402
from gordo_components_tpu_torch.models.base import GordoBase, clone_estimator  # noqa: E402

ESTIMATORS = ("DenseAutoEncoder", "LSTMAutoEncoder", "LSTMForecast", "MultiStepForecast",
              "PatchTSTAutoEncoder", "PatchTSTForecast", "KerasAutoEncoder",
              "KerasLSTMAutoEncoder", "KerasLSTMForecast")
SCALERS = ("MinMaxScaler", "StandardScaler", "InfImputer", "FunctionTransformer")


def _pair(name):
    """(port instance, reference instance) of the class called ``name``."""
    if name in ESTIMATORS:
        return getattr(models, name)(), getattr(ref_models, name)()
    if name in SCALERS:
        return getattr(transformers, name)(), getattr(ref_transformers, name)()
    if name == "Pipeline":
        return (pipeline.Pipeline([transformers.MinMaxScaler(), models.DenseAutoEncoder()]),
                ref_pipeline.Pipeline([ref_transformers.MinMaxScaler(),
                                       ref_models.DenseAutoEncoder()]))
    if name == "FeatureUnion":
        return (pipeline.FeatureUnion([transformers.MinMaxScaler(),
                                       transformers.StandardScaler()]),
                ref_pipeline.FeatureUnion([ref_transformers.MinMaxScaler(),
                                           ref_transformers.StandardScaler()]))
    if name == "TransformedTargetRegressor":
        return (pipeline.TransformedTargetRegressor(models.DenseAutoEncoder(),
                                                    transformers.MinMaxScaler()),
                ref_pipeline.TransformedTargetRegressor(ref_models.DenseAutoEncoder(),
                                                        ref_transformers.MinMaxScaler()))
    assert name == "DiffBasedAnomalyDetector"
    return anomaly.DiffBasedAnomalyDetector(), ref_anomaly.DiffBasedAnomalyDetector()


ALL = (*ESTIMATORS, *SCALERS, "Pipeline", "FeatureUnion", "TransformedTargetRegressor",
       "DiffBasedAnomalyDetector")


def test_the_abstract_methods_are_the_references():
    from gordo_components_tpu.models.anomaly.base import AnomalyDetectorBase as RefDetector
    from gordo_components_tpu.models.base import GordoBase as RefBase

    assert GordoBase.__abstractmethods__ == RefBase.__abstractmethods__
    assert AnomalyDetectorBase.__abstractmethods__ == RefDetector.__abstractmethods__
    assert models.GordoBase is GordoBase and anomaly.AnomalyDetectorBase is AnomalyDetectorBase
    with pytest.raises(TypeError):
        GordoBase()
    with pytest.raises(TypeError):
        AnomalyDetectorBase()


def test_the_defaults_behave_as_the_references():
    class Plain(GordoBase):
        def __init__(self, a=1):
            self.a = a

        def fit(self, X, y=None, **kwargs):
            return self

        def get_metadata(self):
            return {}

        def get_params(self, deep=True):
            return {"a": self.a}

    plain = Plain()
    assert plain.set_params(a=3) is plain and plain.a == 3
    assert plain.get_state() == {} and plain.set_state({"x": 1}) is plain
    copy = clone_estimator(plain)
    assert type(copy) is Plain and copy is not plain and copy.get_params() == {"a": 3}


def _same_params(port, ref):
    """``get_params(deep=False)`` of the two alike: nested estimators (a
    pipeline's named steps too) by class name and their own parameters."""
    ours, theirs = port.get_params(deep=False), ref.get_params(deep=False)
    assert sorted(ours) == sorted(theirs)
    for key, value in ours.items():
        _same(value, theirs[key])


def _same(value, other):
    if hasattr(value, "get_params"):
        assert type(value).__name__ == type(other).__name__
        _same_params(value, other)
    elif isinstance(value, (list, tuple)):
        assert len(value) == len(other)
        for mine, theirs in zip(value, other):
            _same(mine, theirs)
    else:
        assert value == other


@pytest.mark.parametrize("name", ALL)
def test_clone_round_trips_get_params(name):
    port, ref = _pair(name)
    if name in ESTIMATORS:  # set_params is the contract's default in both
        assert port.set_params(epochs=2) is port and ref.set_params(epochs=2) is ref
    copy = clone_estimator(port)
    assert type(copy) is type(port) and copy is not port
    _same_params(copy, port)
    _same_params(copy, ref_clone(ref))


@pytest.mark.parametrize("name", ALL)
def test_isinstance_holds_where_it_holds_in_the_reference(name):
    from gordo_components_tpu.models.anomaly.base import AnomalyDetectorBase as RefDetector
    from gordo_components_tpu.models.base import GordoBase as RefBase

    port, ref = _pair(name)
    assert isinstance(port, GordoBase) == isinstance(ref, RefBase)
    assert isinstance(port, AnomalyDetectorBase) == isinstance(ref, RefDetector)
    assert isinstance(port, GordoBase)


def test_a_reference_artifact_loads_as_instances_of_the_contract(tmp_path):
    from gordo_components_tpu.serializer import dump as ref_dump
    from gordo_components_tpu.serializer import pipeline_from_definition as ref_definition

    from gordo_components_tpu_torch.serializer import load

    config = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": [
            "MinMaxScaler", {"DenseAutoEncoder": {"kind": "feedforward_hourglass",
                                                  "epochs": 1, "batch_size": 16}}]}},
        "transformer": "MinMaxScaler"}}}}
    rows = (np.random.default_rng(3).normal(size=(64, 4)) * 3 + 5).astype(np.float32)
    model = ref_definition(config)
    model.fit(rows, rows)
    ref_dump(model, str(tmp_path / "m"), metadata={"dataset": {"tag_list": list("abcd")}})
    ours = load(str(tmp_path / "m"), device="cpu")
    assert isinstance(ours, AnomalyDetectorBase)
    ttr = ours.base_estimator
    assert isinstance(ttr, GordoBase) and isinstance(ttr.regressor, GordoBase)
    assert all(isinstance(step, GordoBase) for _, step in ttr.regressor.steps)
    assert np.isfinite(ours.anomaly(rows)["total-anomaly-score"]).all()
