"""Small shared helpers of the port: device resolution, config classes,
the build registry, phase timing."""
