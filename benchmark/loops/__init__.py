"""One loop per kind of traffic: ``run(ctx)`` -> (record, numbers,
device, breakdown)."""
