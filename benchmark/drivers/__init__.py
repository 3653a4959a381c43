"""One driver per shape of load; a traffic file names its driver."""
