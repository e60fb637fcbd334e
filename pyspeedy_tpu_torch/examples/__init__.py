"""The JAX package's examples (examples/) on the port: my_first_forecast,
ensemble_forecast and large_ensemble. Each runs as a module
(``python -m pyspeedy_tpu_torch.examples.my_first_forecast``), on the card
unless ``--device cpu`` is given."""
