"""Device engine of the port: encoding, model steps, the bitdense scan,
its closure kernel, and routing."""
