"""Model facade and decode protocol of the port."""
