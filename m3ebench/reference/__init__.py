"""Plain NumPy reference of the mapper's arithmetic, frozen copies that
import nothing of the program: the cost model, the model zoo and task
builder, the genome decode, the BW-allocator simulation and a lower
bound on any mapping's makespan."""
