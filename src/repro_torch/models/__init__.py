"""Dense decoder of the torch port: params, layers, attention, stack."""
