"""``python -m repro_torch.launch.serve`` on the CPU at a small size.

The default (sharded, one slot), ``--single``, ``--autotune`` and
``--durable-dir`` twice (create, then recover with the same recall) must
run to the end with no first use on the request path and print the
reference launcher's lines (recall and latency percentiles,
``recompiles_after_warmup=``, ``autotune:``/``decisions:``, ``health:``).
"""
import json
import re

import pytest
import torch

from repro_torch.launch import serve

SMALL = ["--device", "cpu", "--n-base", "1500", "--dim", "32",
         "--requests", "12", "--buckets", "1,8", "--m", "8", "--efc", "48"]
RESULT = re.compile(r"^router=crouting: recall@10=(\d\.\d{3}) QPS=\d+ "
                    r"p50=[\d.]+ms p95=[\d.]+ms p99=[\d.]+ms "
                    r"recompiles_after_warmup=(\d+)$", re.M)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the launcher runs beside other test processes
    on a shared CPU (the setting is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(capsys, *extra):
    serve.main(SMALL + list(extra))
    out = capsys.readouterr().out
    m = RESULT.search(out)
    assert m, out
    health = json.loads(re.search(r"^health: (.*)$", out, re.M).group(1))
    return out, float(m.group(1)), int(m.group(2)), health


@pytest.mark.parametrize("layout", ["sharded", "single"])
def test_serves_without_first_uses_after_warmup(capsys, layout):
    out, recall, recompiles, health = run(
        capsys, *(["--single"] if layout == "single" else []))
    assert out.startswith("devices: 1\n")
    assert recompiles == 0 and recall >= 0.9
    assert health["backend"]["kind"] == layout
    assert health["autotune"] is None


def test_autotune_attaches_and_decides(capsys):
    out, recall, recompiles, health = run(capsys, "--autotune")
    assert recompiles == 0 and recall >= 0.9
    assert re.search(r"^autotune attached in [\d.]+s: incumbent efs=\d+,W=\d+",
                     out, re.M)
    m = re.search(r"^autotune: (\d+) switches, (\d+) failures, final spec "
                  r"(\S+)$", out, re.M)
    assert m and int(m.group(2)) == 0
    log = json.loads(re.search(r"^decisions: (.*)$", out, re.M).group(1))
    assert log[0]["kind"] == "screen" and log[0]["key"]
    assert health["autotune"]["failures"] == 0
    assert health["autotune"]["incumbent"] == m.group(3)
    assert health["backend"]["kind"] == "sharded"


def test_durable_dir_creates_then_recovers(capsys, tmp_path):
    d = str(tmp_path / "durable")
    out1, recall1, rc1, h1 = run(capsys, "--durable-dir", d)
    assert f"created durable state in {d}" in out1
    out2, recall2, rc2, h2 = run(capsys, "--durable-dir", d)
    assert re.search(rf"^recovered 1500 live rows from {re.escape(d)} "
                     r"\(epoch 0\)$", out2, re.M)
    assert recall1 == recall2 and rc1 == rc2 == 0
    assert h1["backend"]["durable"] and h2["backend"]["durable"]


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised when no GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(SMALL[2:])
