"""Share of the window's plan-cache lookups that hit
(``repro_torch.plan.executor.cache_stats()["plan"]``, differenced over the
window): a repeated query shape should skip the optimiser every time."""


def read(obs):
    before, after = obs["plan_cache"]
    hits = after["hits"] - before["hits"]
    looks = hits + after["misses"] - before["misses"]
    return 100.0 * hits / looks if looks else None
