"""The reference's four example scripts (`examples/*.py`) as modules of
the port, each run as ``python -m repro_torch.examples.<name>``:

- quickstart            train a reduced model for a few steps, then serve it
- elastic_train         fault-tolerant, elastic training end to end
- multi_tenant_serving  FOS multi-tenant acceleration over a fabric
- fos_registry_tour     the logical-hardware abstraction (paper Listings 1-5)

Each keeps its reference's flow, arguments, defaults and printed lines,
and takes `--device` (default `cuda`; `cpu` binds the CPU, nothing falls
back to it).  `main(argv=None)` parses `argv` (the command line when
None).
"""
