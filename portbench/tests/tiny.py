"""Tiny sizes for running every cell on the CPU in the tests: the same
code paths as the card's runs, at sizes a test run holds."""
import time

FIT = {'fit': {'num_samples': 1000, 'verify_ratio': 0.1}}
_PLAN = {'options': {'N_WAYPOINTS': 8, 'NUM_RE_TRIALS': 2, 'MAXITER': 6,
                     'max_speed': 2.0, 'dense_sub': 3},
         'pool_configs': 512, 'pool_problems': 8, 'trace_requests': 1}
MIXES = {
    'baxter_dh.plan': _PLAN,
    'baxter_dh.plan_batch': dict(_PLAN, problems_per_request=4),
    'panda_dh.sweep': {'batch': 512, 'pools': 2, 'check_rows': 512,
                       'trace_requests': 2},
    'panda_dh.update': {'num_samples': 50, 'probe': 256,
                        'check_updates': 10, 'trace_requests': 3},
}


def run(cell_module, name, seed=3, requests=None):
    """One CPU run of a cell at tiny sizes: a 0.3-s window, or with
    ``requests`` a traced slice of that many requests."""
    mix = dict(MIXES[name])
    if requests is not None:
        mix['trace_requests'] = requests
    return cell_module.run(name, seed, 0.3, requests is not None, 'cpu',
                           time.perf_counter(), mix_overrides=mix,
                           config_overrides=FIT)
