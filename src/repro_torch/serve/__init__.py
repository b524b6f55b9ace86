"""Serve stack of the torch port: queue, block pool, scheduler, engines."""
