"""The eval tables the trainers log (copies of trlx_tpu.utils.trackers'
``generations_table`` and ``samples_table``); the trackers themselves
wait for the run floor."""

from typing import Any, Dict, List


def generations_table(queries: List[str], responses: List[str],
                      scores) -> Dict[str, Any]:
    """The PPO eval table: decoded query / response / score rows."""
    return {
        "columns": ["query", "response", "score"],
        "rows": [[q, r, float(s)]
                 for q, r, s in zip(queries, responses, scores)],
    }


def samples_table(samples: List[str], rewards=None,
                  max_rows: int = 128) -> Dict[str, Any]:
    """The ILQL eval table: sampled text (and reward, when scored), the
    first ``max_rows`` rows."""
    if rewards is None:
        return {"columns": ["sample"],
                "rows": [[s] for s in samples[:max_rows]]}
    return {"columns": ["sample", "reward"],
            "rows": [[s, float(r)]
                     for s, r in zip(samples[:max_rows], rewards)]}
