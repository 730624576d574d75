from .sampling import demo_labels, make_sample_fn

__all__ = ["demo_labels", "make_sample_fn"]
