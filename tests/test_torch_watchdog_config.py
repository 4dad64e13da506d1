"""The port's fault-tolerance config and timeouts calculator, held against
``tests/watchdog/test_config.py`` and ``tests/watchdog/test_timeouts.py``: each of their
tests runs here on ``tpu_resiliency_torch.watchdog`` (``torch_port_tests``), on the
port's store. Beside them: both packages build the same config from the same
``--ft-param-*`` overrides and YAML, their calculators give the same timeouts from the
same seeded heartbeat and section times, and the port parses ``--ft-param-*`` and
dicts without PyYAML (the card's machine has none).
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

import tpu_resiliency.watchdog.config as ref_config
import tpu_resiliency.watchdog.timeouts as ref_timeouts
import tpu_resiliency_torch.watchdog.config as port_config
import tpu_resiliency_torch.watchdog.timeouts as port_timeouts
from tests.torch_port_tests import REPO, port_tests


@pytest.fixture
def kv_server():
    from tpu_resiliency_torch.platform.store import KVServer

    server = KVServer(host="127.0.0.1", port=0)
    yield server
    server.close()


port_tests("tests/watchdog/test_config.py", globals())
port_tests("tests/watchdog/test_timeouts.py", globals())


@pytest.mark.parametrize("overrides", [
    {},
    {"rank_heartbeat_timeout": "5", "workload_check_interval": "0.5"},
    {"initial_rank_heartbeat_timeout": "60", "rank_termination_signal": "SIGTERM",
     "stack_dump_grace": "0", "enable_health_checks": "true"},
    {"rank_section_timeouts": "{step: 30, checkpointing: null}", "safety_factor": "2.5"},
])
def test_both_packages_build_the_same_config_from_the_same_overrides(overrides, tmp_path):
    ns = argparse.Namespace(**{f"ft_param_{k}": v for k, v in overrides.items()})
    ref = ref_config.FaultToleranceConfig.from_args(ns)
    port = port_config.FaultToleranceConfig.from_args(ns)
    assert vars(ref) == vars(port)
    ref.to_yaml_file(str(tmp_path / "ref.yaml"))
    port.to_yaml_file(str(tmp_path / "port.yaml"))
    assert (tmp_path / "ref.yaml").read_text() == (tmp_path / "port.yaml").read_text()
    assert vars(port_config.FaultToleranceConfig.from_yaml_file(str(tmp_path / "ref.yaml"))) \
        == vars(ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_both_calculators_give_the_same_timeouts_from_the_same_times(seed):
    rng = np.random.default_rng(seed)
    gaps = rng.uniform(0.05, 2.0, size=20)
    sections = {"step": rng.uniform(0.1, 1.0, size=8), "checkpointing": rng.uniform(1, 5, 3)}
    factor = float(rng.uniform(2.0, 6.0))
    out = []
    for mod in (ref_timeouts, port_timeouts):
        calc = mod.TimeoutsCalc(safety_factor=factor)
        calc.start_time = t = 100.0
        for g in gaps:
            t += float(g)
            calc.update_on_heartbeat(t)
        for name, durations in sections.items():
            for d in durations:
                calc.update_on_section_open(name, t)
                t += float(d)
                calc.update_on_section_close(name, t)
                t += 0.25
        out.append((calc.can_get_hb_timeouts, calc.get_hb_timeouts(),
                    calc.get_section_timeouts()))
    assert repr(out[0]) == repr(out[1])


def test_ft_params_and_dicts_need_no_yaml():
    """``--ft-param-*`` overrides (but ``rank_section_timeouts``) and ``from_dict`` run
    where PyYAML cannot be imported; only the YAML paths ask for it."""
    code = (
        "import argparse, sys\n"
        "sys.modules['yaml'] = None\n"
        "from tpu_resiliency_torch.watchdog.config import FaultToleranceConfig as C\n"
        "from tpu_resiliency_torch.launcher.launch import extract_ft_params\n"
        "argv, ns = extract_ft_params(['--ft-param-rank_heartbeat_timeout', '5',\n"
        "    '--ft-param-workload_check_interval=0.5', 'train.py'])\n"
        "cfg = C.from_args(ns)\n"
        "assert (cfg.rank_heartbeat_timeout, cfg.workload_check_interval) == (5, 0.5), cfg\n"
        "assert C.from_dict({'safety_factor': 2.0}).safety_factor == 2.0\n"
        "try:\n"
        "    C.from_yaml_file('x.yaml')\n"
        "except ImportError:\n"
        "    print('yaml asked for')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "yaml asked for"
