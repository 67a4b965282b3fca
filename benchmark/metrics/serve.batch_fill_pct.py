"""Share of the service's batch slots that carried a request in the window:
utterances / (batches x batch size), from ``EnhanceService.stats``."""


def read(run):
    s = run.service
    if not s or not s["batches"]:
        return None
    return 100.0 * s["utterances"] / (s["batches"] * run.batch_size)
