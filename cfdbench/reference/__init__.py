"""Plain references of the benchmark's configurations.

Each module here is a straightforward PyTorch implementation of one
family of configurations, written for the benchmark and importing nothing
of the program under test. A configuration's file names its module under
``"reference"``. Every module offers the same three functions:

    check_supported(config)                      raise for a setting it does not implement
    initial_fields(config, pos, radius, ...)     the fields the start of a run derives
    run_chunk(config, state, n_steps, ...)       advance a state dict n_steps coupled steps
"""
