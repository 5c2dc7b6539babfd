"""The port's NCS, IROC and data-lake readers against the reference's, on
the fixture tree that ``tests/test_lake_providers.py`` builds (both
layouts: yearly per-tag parquet and CSV, concatenated IROC CSVs with the
older column names), case for case, and each provider's series held to
the reference's ``pd.Series`` exactly: the index as int64 nanoseconds and
the values to the bit. Then the Azure transport through an injected
client, the credentials' refusal points (the SDK's included), and the rule
that secrets are never serialized.
"""

from datetime import datetime, timezone

import numpy as np
import pandas as pd
import pytest

from gordo_components_tpu.dataset.data_provider import DataLakeProvider as RefDataLake
from gordo_components_tpu.dataset.data_provider import IrocReader as RefIroc
from gordo_components_tpu.dataset.data_provider import NcsReader as RefNcs
from gordo_components_tpu.dataset.sensor_tag import SensorTag as RefTag

from gordo_components_tpu_torch.dataset import GordoBaseDataset
from gordo_components_tpu_torch.dataset.data_provider import (
    DataLakeProvider,
    GordoBaseDataProvider,
    IrocReader,
    NcsReader,
)
from gordo_components_tpu_torch.dataset.data_provider.azure_utils import (
    ENV_AUTH_VAR,
    ServicePrincipal,
    parse_dl_service_auth_str,
)
from gordo_components_tpu_torch.dataset.sensor_tag import SensorTag

from test_lake_providers import FakeADLClient, lake  # noqa: F401 - the shared fixture tree

START = datetime(2022, 6, 1, tzinfo=timezone.utc)
END = datetime(2023, 6, 1, tzinfo=timezone.utc)


def _same(ours, ref):
    """Port triples against the reference's series: names, index ns and
    values exactly."""
    ours, ref = list(ours), list(ref)
    assert [name for name, _, _ in ours] == [s.name for s in ref]
    for (_, ns, values), series in zip(ours, ref):
        np.testing.assert_array_equal(ns, series.index.as_unit("ns").asi8)
        np.testing.assert_array_equal(values, series.to_numpy(dtype=np.float64))
    return ours


def _load(provider, tags):
    return provider.load_series(START, END, [SensorTag(*t) for t in tags])


def _ref_load(provider, tags):
    return provider.load_series(pd.Timestamp(START), pd.Timestamp(END), [RefTag(*t) for t in tags])


def test_ncs_reads_yearly_parquet_across_year_boundary(lake):
    tags = [("tag-n1", "asset-ncs")]
    reader = NcsReader(base_dir=str(lake))
    assert reader.can_handle_tag(SensorTag(*tags[0]))
    ((_, ns, values),) = _same(_load(reader, tags), _ref_load(RefNcs(base_dir=str(lake)), tags))
    assert ns.min() >= START.timestamp() * 1e9 and ns.max() < END.timestamp() * 1e9
    assert (values < 2022.5).any() and (values > 2022.5).any()
    assert (np.diff(ns) > 0).all()


def test_ncs_csv_fallback_and_partial_history(lake):
    tags = [("tag-n2", "asset-ncs")]
    ((_, ns, _),) = _same(_load(NcsReader(base_dir=str(lake)), tags),
                          _ref_load(RefNcs(base_dir=str(lake)), tags))
    assert pd.Timestamp(ns.min(), tz="UTC").year == 2023


def test_ncs_missing_tag_raises(lake):
    reader = NcsReader(base_dir=str(lake))
    assert not reader.can_handle_tag(SensorTag("no-such-tag", "asset-ncs"))
    with pytest.raises(FileNotFoundError, match="no-such-tag"):
        list(_load(reader, [("no-such-tag", "asset-ncs")]))


def test_ncs_dry_run_reads_no_file(lake):
    class Counting(FakeADLClient):
        pass

    fs_client = Counting(lake)
    from gordo_components_tpu_torch.dataset.data_provider.azure_utils import ADLFileSystem

    reader = NcsReader(base_dir=str(lake), fs=ADLFileSystem(fs_client))
    assert list(reader.load_series(START, END, [SensorTag("tag-n1", "asset-ncs")],
                                   dry_run=True)) == []
    assert fs_client.opened == []


def test_iroc_reads_concatenated_csvs_with_reference_columns(lake):
    tags = [("tag-i1", "asset-iroc"), ("tag-i2", "asset-iroc")]
    series = _same(_load(IrocReader(base_dir=str(lake)), tags),
                   _ref_load(RefIroc(base_dir=str(lake)), tags))
    assert len(series[0][1]) == 365 * 24
    assert series[1][2].mean() > 5


def test_iroc_missing_rows_raise(lake):
    with pytest.raises(ValueError, match="no rows"):
        list(_load(IrocReader(base_dir=str(lake)), [("tag-zz", "asset-iroc")]))


def test_iroc_caches_parsed_files_per_mtime(lake):
    reader = IrocReader(base_dir=str(lake))
    tags = [("tag-i1", "asset-iroc")]
    list(_load(reader, tags))
    cached = dict(reader._cache)
    list(_load(reader, tags))
    assert reader._cache == cached and len(cached) == 2


def test_data_lake_provider_dispatches_by_layout(lake):
    tags = [("tag-n1", "asset-ncs"), ("tag-i1", "asset-iroc"), ("tag-n2", "asset-ncs")]
    _same(_load(DataLakeProvider(base_dir=str(lake)), tags),
          _ref_load(RefDataLake(base_dir=str(lake)), tags))


def test_data_lake_provider_requires_some_transport():
    with pytest.raises(ValueError, match="transport"):
        DataLakeProvider()


def test_azure_transport_reads_both_layouts_via_fake_client(lake):
    seen = {}

    def factory(storename, principal, interactive):
        seen.update(storename=storename, principal=principal, interactive=interactive)
        return FakeADLClient(lake)

    provider = DataLakeProvider(storename="prodlake",
                                dl_service_auth_str="my-tenant:my-client:my-secret",
                                adl_root=str(lake), client_factory=factory)
    assert not seen  # construction is offline: the factory runs at the first touch
    assert provider.can_handle_tag(SensorTag("tag-n1", "asset-ncs"))
    assert seen == {"storename": "prodlake", "interactive": False,
                    "principal": ServicePrincipal("my-tenant", "my-client", "my-secret")}
    tags = [("tag-n1", "asset-ncs"), ("tag-i2", "asset-iroc")]
    _same(_load(provider, tags), _ref_load(RefDataLake(base_dir=str(lake)), tags))


def test_azure_env_var_credentials(lake, monkeypatch):
    monkeypatch.setenv(ENV_AUTH_VAR, "env-tenant:env-client:env-secret")
    seen = {}

    def factory(storename, principal, interactive):
        seen["principal"] = principal
        return FakeADLClient(lake)

    DataLakeProvider(storename="prodlake", adl_root=str(lake),
                     client_factory=factory).can_handle_tag(SensorTag("tag-n1", "asset-ncs"))
    assert seen["principal"] == ServicePrincipal("env-tenant", "env-client", "env-secret")


def test_azure_auth_validation_and_refusal_points(monkeypatch):
    monkeypatch.delenv(ENV_AUTH_VAR, raising=False)
    with pytest.raises(ValueError, match="':'-separated"):
        parse_dl_service_auth_str("tenant-only")
    with pytest.raises(ValueError, match="blank"):
        parse_dl_service_auth_str("tenant::secret")
    assert parse_dl_service_auth_str("t:c:se:cr:et").client_secret == "se:cr:et"
    with pytest.raises(ValueError, match="':'-separated"):
        DataLakeProvider(storename="s", dl_service_auth_str="oops")
    with pytest.raises(ValueError, match="credentials"):
        DataLakeProvider(storename="prodlake").can_handle_tag(SensorTag("tag-n1", "asset-ncs"))


def test_azure_refuses_without_the_sdk(monkeypatch):
    """The SDK is imported at the first lake touch only, and its absence
    is a RuntimeError naming the package (this machine has no SDK; the
    import is blocked besides, so the case holds wherever it runs)."""
    import sys

    monkeypatch.setitem(sys.modules, "azure", None)
    monkeypatch.delenv(ENV_AUTH_VAR, raising=False)
    provider = DataLakeProvider(storename="prodlake", interactive=True)
    with pytest.raises(RuntimeError, match="azure-datalake-store"):
        provider.can_handle_tag(SensorTag("tag-n1", "asset-ncs"))


def test_azure_secrets_never_serialized(lake):
    provider = DataLakeProvider(storename="prodlake", dl_service_auth_str="t:c:s3cr3t",
                                adl_root=str(lake), client_factory=lambda *a: FakeADLClient(lake))
    serialized = provider.to_dict()
    assert "s3cr3t" not in str(serialized) and "dl_service_auth_str" not in str(serialized)
    assert "client_factory" not in str(serialized)
    assert serialized["storename"] == "prodlake"
    rebuilt = GordoBaseDataProvider.from_dict(serialized)
    assert isinstance(rebuilt, DataLakeProvider) and rebuilt.storename == "prodlake"


@pytest.mark.parametrize("type_name", [
    "DataLakeProvider",
    "gordo_components_tpu.dataset.data_provider.ncs_iroc.DataLakeProvider",
    "gordo_components_tpu.dataset.data_provider.DataLakeProvider",
    "gordo_components_tpu_torch.dataset.data_provider.ncs_iroc.DataLakeProvider",
])
def test_data_lake_provider_round_trips_through_config(lake, type_name):
    provider = GordoBaseDataProvider.from_dict({"type": type_name, "base_dir": str(lake)})
    assert isinstance(provider, DataLakeProvider)
    rebuilt = GordoBaseDataProvider.from_dict(provider.to_dict())
    assert isinstance(rebuilt, DataLakeProvider) and rebuilt.base_dir == str(lake)
    assert {k: v for k, v in provider.to_dict().items() if k != "type"} == {
        k: v for k, v in RefDataLake(base_dir=str(lake)).to_dict().items() if k != "type"}


def test_fixture_tree_loads_through_timeseries_dataset(lake):
    """A data config over both layouts gives the reference's rows."""
    from gordo_components_tpu.dataset import GordoBaseDataset as RefDataset

    config = {
        "type": "TimeSeriesDataset",
        "data_provider": {"type": "DataLakeProvider", "base_dir": str(lake)},
        "train_start_date": START.isoformat(),
        "train_end_date": END.isoformat(),
        "tag_list": [{"name": "tag-n1", "asset": "asset-ncs"},
                     {"name": "tag-i1", "asset": "asset-iroc"},
                     {"name": "tag-i2", "asset": "asset-iroc"}],
        "resolution": "6h",
    }
    dataset = GordoBaseDataset.from_dict(config)
    X, _ = dataset.get_data()
    ref_X, _ = RefDataset.from_dict(config).get_data()
    assert dataset.x_columns == list(ref_X.columns) == ["tag-n1", "tag-i1", "tag-i2"]
    assert len(X) > 100
    np.testing.assert_array_equal(dataset.index, ref_X.index.as_unit("ns").asi8)
    np.testing.assert_array_equal(X, ref_X.to_numpy(dtype=np.float32))
