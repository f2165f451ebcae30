"""From the process's start until the window opens."""


def read(cell):
    return cell.window_open - cell.t_process
