"""Framework-free helpers of the port (copies of the JAX package's) and the
seeding of its explicit random generators."""
