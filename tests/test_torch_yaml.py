"""The port's YAML reader (easyhec_torch/config/yaml_lite.py) against PyYAML.

Every case reads one document with ``yaml_lite.load`` and with
``yaml.safe_load`` and asserts the same value with the same types, floats by
their bits (a NaN equals a NaN, -0.0 is not 0.0): tolerance exact, in every
group. The groups: every ``configs/*.yaml``; ``save_config``'s JSON for the
default Config and for each loaded config; override values as the CLIs get
them; flow collections spanning lines; hypothesis-drawn plain scalars over
digits, signs, ``.``, ``e``, ``E``, ``_``, ``:``, ``x``, ``b`` and letters,
where a timestamp shape must raise. Syntax outside the reader's subset
(anchors, aliases, tags, block scalars, several documents, dates) raises
ValueError naming the line.
"""
import dataclasses
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from easyhec_torch.config import Config, apply_overrides, load_config, save_config
from easyhec_torch.config.yaml_lite import load
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))


def _same(a, b) -> bool:
    """Equal values of equal types, recursively; floats bit for bit."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or (
            a == b and math.copysign(1.0, a) == math.copysign(1.0, b))
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return len(a) == len(b) and all(
            _same(ka, kb) and _same(a[ka], b[kb]) for ka, kb in zip(a, b))
    return a == b


def _check(text: str):
    want = yaml.safe_load(text)
    got = load(text)
    assert _same(got, want), (text, got, want)
    return got


@pytest.mark.parametrize("name", CONFIGS)
def test_config_files_read_as_pyyaml(name):
    data = _check((ROOT / "configs" / name).read_text())
    assert isinstance(data, dict) and "model" in data


@pytest.mark.parametrize("name", [None] + CONFIGS)
def test_save_config_output_reads_as_pyyaml(name, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    cfg = Config() if name is None else load_config(ROOT / "configs" / name)
    save_config(cfg, tmp_path / "config.yaml")
    data = _check((tmp_path / "config.yaml").read_text())
    assert data == dataclasses.asdict(cfg)
    # and it loads back as the config it was written from
    assert dataclasses.asdict(load_config(tmp_path / "config.yaml")) == dataclasses.asdict(cfg)


OVERRIDE_VALUES = [
    "[[0.9396, 0.342, 0.0, -0.64], [0.171, -0.4698, -0.866, 0.4958], "
    "[-0.2962, 0.8138, -0.5, 1.2412], [0.0, 0.0, 0.0, 1.0]]",
    "[base, upper, fore]", "[a, b]", "[]", "{}", "null", "~", "", "Null", "NULL",
    "on", "off", "On", "OFF", "yes", "no", "true", "False", "y", "n",
    "'/data/run: 1 #2'", '"C:\\\\runs\\\\x #1"', '"tab\\there \\u00e9 \\x41"',
    "'it''s'", "runs/sim_mini", "/tmp/a#b", "http://host:8080/x",
    "3e-3", "1e-05", "1.0e3", "1.0e+3", "1.0E-3", "0.003", "-0.5", "+2.", ".5", "-.5",
    "010", "08", "0o10", "0x1F", "0b101", "-0", "1_000", "1:30", "190:20:30", "1:30.5",
    "1:60", ".inf", "-.inf", "+.Inf", ".nan", ".NaN", "-.nan", "0.", "480", "-3",
    "adam", "warmup_cosine", "a b  c", "{x: 1, 'y': [2, 3]}",
]


@pytest.mark.parametrize("raw", OVERRIDE_VALUES)
def test_override_values_read_as_pyyaml(raw):
    _check(raw)


def test_apply_overrides_split_on_the_first_equals():
    cfg = apply_overrides(Config(), ["output_dir='runs/a=b: c'", "solver.max_lr=3e-3",
                                     "render.fused=off", "model.H=0x2d0",
                                     "model.use_links=[base, upper, fore]"])
    assert cfg.output_dir == "runs/a=b: c"
    assert cfg.solver.max_lr == "3e-3"  # PyYAML's quirk, kept: no dot, a string
    assert cfg.render.fused is False and cfg.model.H == 720
    assert cfg.model.use_links == ["base", "upper", "fore"]


FLOW_DOCUMENTS = [
    "a: [1,\n2]",
    "use_links: [panda_link0, panda_link1,\n            panda_link2]\n",
    "T: [[ 0.9,  0.3, 0.0, -0.6],\n    [ 0.1, -0.4, -0.8,  0.4],  # row 2\n"
    "    [-0.2,  0.8, -0.5,  1.2],\n    [ 0.0,  0.0,  0.0,  1.0]]\n",
    "{\n  \"model\": {\n    \"H\": 480,\n    \"use_links\": [\n      \"a\",\n"
    "      \"b\"\n    ]\n  },\n  \"dbg\": false\n}",
    "[a\n, b]",
    "a: [1, 2\n  ,3]",
    "m: {a: 1,\n  b: [x, y],\n  c: {d: e}}\n",
    "[a, # comment\n b,]",
    "{\"a\":1, 'b':[2,{c: ~}]}",
    "x:\n  - [1, 2]\n  - {a: b}\ny: [\n]\n",
]


@pytest.mark.parametrize("text", FLOW_DOCUMENTS)
def test_flow_collections_spanning_lines(text):
    _check(text)


BLOCK_DOCUMENTS = [
    "", "# only a comment\n", "a: 1\na: 2\n", "a:\n- x\n- y\n", "- a: 1\n  b: 2\n- c\n",
    "- - x\n  - y\n", "a:\n  b:\n    c: 1\n  d: 2\ne: f\n", "a: b #c\nd: 'e' # f\n",
    "model:\n  init_Tc_c2b:\n  - [1.0, 0.0]\n  - [0.0, 1.0]\n", "key:\n\nother: 1\n",
    "1: a\n1.0: b\n", "'quoted key': 1\n\"k\": 2\n", "a: x#y\n", "a:\r\n  b: 1\r\n",
]


@pytest.mark.parametrize("text", BLOCK_DOCUMENTS)
def test_block_documents(text):
    _check(text)


_PLAIN = st.text(alphabet="0123456789+-._:eExXbBaoinfNTYlsu", min_size=1, max_size=12)


@settings(max_examples=400, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_PLAIN)
@example("3e-3")
@example("1.0e+3")
@example("010")
@example("1:30")
@example("2001-12-14")
@example("0b_")
def test_plain_scalars_resolve_as_pyyaml(s):
    try:
        want = yaml.safe_load(s)
    except Exception as e:  # noqa: BLE001 - PyYAML raises several types
        with pytest.raises(ValueError, match="line 1"):
            load(s)
        return
    if type(want).__name__ in ("date", "datetime"):
        with pytest.raises(ValueError, match="line 1, column 1: .*timestamp"):
            load(s)
        return
    assert _same(load(s), want), (s, want)


@settings(max_examples=100, deadline=None, derandomize=True, database=None)
@given(st.from_regex(r"\A[0-9]{4}-[0-9]{2}-[0-9]{2}\Z"))
def test_timestamps_raise(s):
    with pytest.raises(ValueError, match="line 1"):
        load(s)
    with pytest.raises(ValueError, match="line 2"):
        load(f"a: 1\nb: {s}\n")


@pytest.mark.parametrize("text, line", [
    ("a: &x 1\nb: *x\n", 1),
    ("a: 1\nb: *x\n", 2),
    ("a: !!str 1\n", 1),
    ("a: 1\nb: |\n  text\n", 2),
    ("a: >\n  folded\n", 1),
    ("a: 1\n---\nb: 2\n", 2),
    ("---\na: 1\n", 1),
    ("a: 1\n...\n", 2),
    ("a: 2001-12-14\n", 1),
    ("a: 1\nb:\n  c: 2001-12-14 21:59:43.10 -5\n", 3),
    ("? a\n: b\n", 1),
    ("a: x\n  continued\n", 2),
    ("a: 'two\n  lines'\n", 1),
    ("a: [b: 1]\n", 1),
    ("a: <<\n", 1),
    ("a:\t1\n", 1),
    ("a: b: c\n", 1),
    ("a: [1, 2\n", 1),
])
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}, column"):
        load(text)
