"""The counterexample SVG (`checker/linear_report.py`): the port's
`render_analysis` equals the reference's for the same history and
analysis — the golden invalid histories with the reference checker's
final-paths, a valid analysis, an empty history, crashed and failed ops
— and the checker writes it as linear.svg through a test's store on
failure (under the opts' subdirectory), never on success, and a store
that fails does not fail the check."""

import json
import pathlib

import pytest
import torch

from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import linear_report as ref_report
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.checker import linear_report
from jepsen_tpu_torch.checker.linearizable import Linearizable
from jepsen_tpu_torch.history import History
from torch_jax_cache import release_compiled_programs  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden"
INVALID = [e for e in json.loads((GOLDEN / "manifest.json").read_text())
           if not e["valid"]]
MODEL_NAMES = {"cas-register": "CASRegister", "fifo-queue": "FIFOQueue",
               "unordered-queue": "UnorderedQueue", "set": "GSet",
               "mutex": "Mutex"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Store:
    """A store as the checker sees one: write_file(parts, text) and
    path(*parts)."""

    def __init__(self, root: pathlib.Path):
        self.root = root

    def path(self, *parts):
        return str(self.root.joinpath(*[str(p) for p in parts]))

    def write_file(self, parts, text):
        p = pathlib.Path(self.path(*parts))
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)


@pytest.mark.parametrize("entry", INVALID, ids=[e["file"] for e in INVALID])
def test_svg_equals_the_references(entry):
    text = (GOLDEN / entry["file"]).read_text()
    rh = RefHistory.from_edn(text).index()
    ph = History.from_edn(text).index()
    analysis = RefLinearizable(
        getattr(ref_models, MODEL_NAMES[entry["model"]])(), "wgl").check(
        {}, rh)
    assert analysis["valid?"] is False
    svg = linear_report.render_analysis(ph, analysis)
    assert svg == ref_report.render_analysis(rh, analysis)
    assert svg.startswith("<svg") and "No legal linearization" in svg


@pytest.mark.parametrize("seed", [1, 2])
def test_svg_of_crashed_and_failed_ops(seed):
    kw = {"n_ops": 30, "n_processes": 4, "crash_p": 0.1, "fail_p": 0.1,
          "seed": seed}
    from jepsen_tpu import histories as ref_histories
    rh = ref_histories.rand_register_history(**kw)
    ph = histories.rand_register_history(**kw)
    analysis = {"valid?": False, "op": {"index": 3, "f": "read",
                                        "value": 9},
                "final-paths": [[{"op": {"index": 0}, "model": "r0"},
                                 {"op": {"index": 3}, "model": "r1"}]]}
    assert linear_report.render_analysis(ph, analysis, title="t") == \
        ref_report.render_analysis(rh, analysis, title="t")
    assert linear_report.render_analysis(ph, {"valid?": True}) == \
        ref_report.render_analysis(rh, {"valid?": True})


def test_svg_of_an_empty_history():
    assert linear_report.render_analysis(History(), {}) == \
        ref_report.render_analysis(RefHistory(), {})


@pytest.mark.parametrize("algo", ["packed", "linear", "torch", "wgl"])
def test_checker_writes_linear_svg_on_failure(tmp_path, algo):
    entry = next(e for e in INVALID if e["file"] == "register-invalid.edn")
    h = History.from_edn((GOLDEN / entry["file"]).read_text()).index()
    store = Store(tmp_path)
    r = Linearizable(models.CASRegister(), algo, device="cpu").check(
        {"store": store}, h, {"subdirectory": "independent"})
    assert r["valid?"] is False
    svg = (tmp_path / "independent" / "linear.svg").read_text()
    assert svg == linear_report.render_analysis(h, r)
    assert linear_report.render_analysis_file(h, r, {"store": store}) == \
        str(tmp_path / "linear.svg")
    assert linear_report.render_analysis_file(h, r, {}) is None


def test_no_svg_on_success_and_a_failing_store_does_not_fail(tmp_path):
    h = histories.rand_register_history(n_ops=20, seed=4)
    r = Linearizable(models.CASRegister(), "packed").check(
        {"store": Store(tmp_path)}, h)
    assert r["valid?"] is True and not list(tmp_path.iterdir())

    class Broken(Store):
        def write_file(self, parts, text):
            raise OSError("disk full")

    bad = History.from_edn((GOLDEN / "register-invalid.edn").read_text())
    r = Linearizable(models.CASRegister(), "packed").check(
        {"store": Broken(tmp_path)}, bad.index())
    assert r["valid?"] is False and r["final-paths"]
