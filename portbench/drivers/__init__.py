"""Traffic drivers, one module per `driver` kind of a traffic file."""
