from istvt_tpu_torch.compat.from_jax import params_from_jax  # noqa: F401
