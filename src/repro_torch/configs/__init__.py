"""Model configurations of the port: copies of the JAX package's numbers,
and each arch's ``dryrun_bundle`` (``launch/dryrun.py`` sizes them for a
many-card H100 deployment)."""
