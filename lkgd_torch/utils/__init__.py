"""Weight porting helpers of the port."""
