from nns_tpu_torch.utils.timing import Timer, now_ns, time_callable, warmup  # noqa: F401
