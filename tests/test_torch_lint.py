"""The port's AST lint (`repro_torch.analysis.lint`) against the JAX
package's, on its fixtures, and its own rules.

  - On the JAX package's fixtures (tests/fixtures/analysis, read as text)
    the port reports what JAX's lint reports for the rules the catalogs
    share; the key-reuse pair is read with `jax.random` spelled as the
    port's `repro_torch.random`, the generator the port's rule keys on.
  - Each port-only rule has a bad and a good snippet inline.
  - The two pragma grammars: `# repro: allow[...]` for shared rules,
    `# repro_torch: allow[...]` for the port's, each reporting the other's
    names, and the JAX lint blind to the port's grammar.
  - `src/repro_torch` lints clean; the CLI's exit codes.
"""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.analysis import RULES as JAX_RULES
from repro.analysis import lint_source as jax_lint_source
from repro_torch.analysis import RULES, lint_paths, lint_source
from repro_torch.analysis.rules import PORT_ONLY, REPLACED, SHARED, pragma_lines

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "analysis")
SRC = os.path.join(ROOT, "src")


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHARED_FIXTURES = {"key-reuse": "key_reuse",
                   "unguarded-mutation": "unguarded_mutation",
                   "lock-discipline": "lock_discipline",
                   "silent-except": "silent_except",
                   "wall-clock": "wall_clock"}


def _read(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return f.read()


def _as_port(src):
    """A fixture with JAX's key API spelled as the port's."""
    return src.replace("import jax\n", "import repro_torch.random\n").replace(
        "jax.random.", "repro_torch.random.")


def _hits(violations, rules):
    return sorted((v.line, v.rule) for v in violations if v.rule in rules)


def test_catalogs():
    assert set(SHARED) == set(RULES) & set(JAX_RULES)
    assert set(RULES) == set(SHARED) | set(PORT_ONLY)
    assert set(REPLACED) == set(JAX_RULES) - set(SHARED)
    assert set(REPLACED.values()) <= set(PORT_ONLY)
    assert all(RULES[r] for r in RULES)


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", sorted(SHARED_FIXTURES))
def test_shared_rules_agree_with_jax_on_its_fixtures(rule, kind):
    src = _read(f"{kind}_{SHARED_FIXTURES[rule]}.py")
    want = _hits(jax_lint_source(src), set(SHARED))
    port_src = _as_port(src) if rule == "key-reuse" else src
    got = _hits(lint_source(port_src), set(SHARED))
    assert got == want
    assert (rule in {r for _, r in got}) == (kind == "bad")


@pytest.mark.parametrize("name", ["pragma_allowed.py", "pragma_unknown_rule.py"])
def test_pragma_fixtures_agree_with_jax(name):
    src = _read(name)
    want = [(v.line, v.rule) for v in jax_lint_source(src)]
    got = [(v.line, v.rule) for v in lint_source(src)]
    assert got == want
    if name == "pragma_allowed.py":
        assert got == []
    else:
        assert any("unknown rule" in v.message for v in lint_source(src))


CAPTURE = '''
import torch


def capture(g, x):
    with torch.cuda.graph(g):
        step(x)
'''
#: rule -> (bad snippet, good snippet); each is linted with CAPTURE
#: appended, so `step` is captured into a CUDA graph
PORT_CASES = {
    "host-read-in-capture": ('''
import time

def step(x):
    return x * time.perf_counter()
''', '''
def step(x):
    return x * 2.0
'''),
    "host-sync-in-capture": ('''
def step(x):
    return x.sum().item()
''', '''
def step(x):
    return x.sum()
'''),
    "tensor-branch": ('''
def step(x):
    y = torch.sum(x)
    if y > 0:
        return x
    return -x
''', '''
def step(x):
    y = torch.sum(x)
    if x.shape[0] > 0:
        return torch.where(y > 0, x, -x)
    return x
'''),
    "read-after-overwrite": ('''
def step(opt, grads, state, params, buf, new):
    old = params["w"]
    opt.update_(grads, state, params)
    alias = buf
    buf.copy_(new)
    return old + alias
''', '''
def step(opt, grads, state, params, buf, new):
    old = params["w"].clone()
    opt.update_(grads, state, params)
    buf.copy_(new)
    return old + buf
'''),
}


@pytest.mark.parametrize("rule", sorted(PORT_CASES))
def test_port_rules_trip_on_bad_and_not_on_good(rule):
    bad, good = PORT_CASES[rule]
    hits = lint_source(textwrap.dedent(bad) + CAPTURE)
    assert rule in {v.rule for v in hits}, hits
    assert not [v for v in lint_source(textwrap.dedent(good) + CAPTURE)
                if v.rule == rule]
    if rule == "read-after-overwrite":
        assert len([v for v in hits if v.rule == rule]) == 2


def test_capture_roots_other_than_a_graph_block():
    """A function handed to the fused trainer, and one called while host
    syncs raise, are captured; the same code uncaptured is not linted."""
    body = "def step(x):\n    return float(torch.sum(x))\n"
    fused = body + "\ndef train(s):\n    return run_fused(step, s, 8)\n"
    sync = body + ('\ndef run(x):\n    torch.cuda.set_sync_debug_mode("error")\n'
                   "    step(x)\n    torch.cuda.set_sync_debug_mode(0)\n")
    for src in (fused, sync):
        assert {v.rule for v in lint_source("import torch\n" + src)} == {
            "host-sync-in-capture"}
    assert lint_source("import torch\n" + body) == []


def test_pragma_grammars():
    bad = textwrap.dedent(PORT_CASES["tensor-branch"][0]) + CAPTURE
    line = next(i for i, l in enumerate(bad.splitlines(), 1) if "if y" in l)
    lines = bad.splitlines()

    def with_comment(comment):
        out = list(lines)
        out[line - 1] += f"  # {comment}"
        return "\n".join(out) + "\n"

    assert lint_source(with_comment(
        "repro_torch: allow[tensor-branch] on purpose")) == []
    # a port rule in JAX's grammar allows nothing and is reported
    hits = lint_source(with_comment("repro: allow[tensor-branch] wrong grammar"))
    assert {v.rule for v in hits} == {"tensor-branch", "silent-except"}
    assert any("`# repro_torch: allow" in v.message for v in hits)
    # a shared rule in the port's grammar too
    wall = "import time\n\n\ndef f():\n    return time.time()  # repro_torch: allow[wall-clock] x\n"
    assert {v.rule for v in lint_source(wall)} == {"wall-clock", "silent-except"}
    assert lint_source(wall.replace("repro_torch:", "repro:")) == []
    # the JAX lint does not read the port's grammar
    assert jax_lint_source(with_comment("repro_torch: allow[tensor-branch] x")) == []
    assert pragma_lines("x = 1  # repro_torch: allow[tensor-branch] x\n") == {
        1: {"tensor-branch"}, 2: {"tensor-branch"}}


def test_port_source_tree_is_clean():
    hits = lint_paths([os.path.join(SRC, "repro_torch")])
    assert hits == [], "\n".join(str(v) for v in hits)


def test_cli_exit_codes(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(PORT_CASES["host-sync-in-capture"][0]) + CAPTURE)
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                          str(bad)], env=env, capture_output=True, text=True)
    assert out.returncode == 1 and "[host-sync-in-capture]" in out.stdout
    good = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                           os.path.join(FIXTURES, "good_wall_clock.py")],
                          env=env, capture_output=True, text=True)
    assert good.returncode == 0
