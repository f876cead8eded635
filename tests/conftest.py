"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated on host CPU devices
(xla_force_host_platform_device_count) per SURVEY.md §4. The GPU runs
through ``python chip_smoke.py``, never through these tests.
"""

import os

# the CPU platform is set through jax.config after import as well as
# through the environment, so an installed GPU plugin cannot take over
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    return FIXTURES


@pytest.fixture(scope="session")
def mini_taxdb():
    from megapath.taxonomy import TaxDB

    db = TaxDB(size=1024)
    db.read_nodes(FIXTURES / "nodes.dmp")
    db.read_names(FIXTURES / "names.dmp")
    db.read_acc2tid(FIXTURES / "acc2tid.map")
    return db
