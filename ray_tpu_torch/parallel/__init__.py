"""Device meshes, the logical-axis rules and ring attention."""
