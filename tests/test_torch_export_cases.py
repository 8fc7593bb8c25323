"""The serving export's multi-phrase and RES cases (JAX's
tests/test_export.py:94 and :119), with the checks and tolerances of
tests/test_torch_export.py, whose REC case they repeat: the loaded
program against the live port model and against reftr_tpu, the graph's
one op per attention call (BERT's twice under multi-phrase), the
manifest, --selfcheck and ServingModel (RES: its masks)."""

import pytest

from test_torch_export import (check_against_live_and_jax, check_graph,
                               check_manifest, check_serving_model,
                               export_case)


@pytest.fixture(scope="module", params=["multi", "masks"])
def exported(request, tmp_path_factory):
    return export_case(request.param, tmp_path_factory)


@pytest.mark.parametrize("check", [check_against_live_and_jax, check_graph,
                                   check_manifest, check_serving_model])
def test_export_case(exported, check):
    check(exported)
